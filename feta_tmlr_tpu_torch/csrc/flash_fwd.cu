// Online-softmax GraphiT attention forward, f32, for sm_90a.
//
// Replaces the TPU kernel feta_tmlr_tpu/ops/pallas/flash_attention.py
// `_fwd_kernel` (launched by `_call_fwd`). For one (graph b, head h):
//
//   s[i,j]  = (xa_h[i]·x[j] + cq[i] + ck[j] + c0) * inv_sqrt,
//             -1e30 where key j is padding
//   m[i]    = max_j s[i,j]           e[i,j] = exp(s[i,j] - m[i])
//   pd[i,j] = pe[i,j] * deg[j]       (either may be absent: 1)
//   se[i]   = sum_j e                su[i]  = sum_j e*pd   (NO key mask)
//   out[i]  = qmask[i] * (sum_j e*pd*kmask[j] * vw[j]) / div[i]
//   div[i]  = |su/se| > 1e-9 ? su : se
//
// and emits out [B,H,N,DV] plus the row statistics m, se, su [B,H,N],
// which the column-statistics kernel (colstat.cu) consumes. The running
// (m, se, su) triple is rescaled by exp(m_old - m_new) per key tile, so no
// [N, N] tile ever reaches device memory.
//
// Summation order: each key tile's P·V goes into a fresh partial that is
// added to the rescaled accumulator once per tile, as se and su are. One
// f32 accumulator over all N keys in order rounds ~4x worse at N=2048
// (measured on the SBM model's layers, `chip_smoke.py --precision`).
//
// What bounds it on the H100: arithmetic. Per (b, h) it does
// 2·N²·(D + DV) FMA-flops on CUDA cores in full f32 (no TF32), against 67
// TFLOP/s; the bytes (xa, x, vw once, pe once per graph) are ~1/30 of what
// the card could stream in that time. The design therefore keeps both
// products in registers from shared memory: a 64x64 score tile per block,
// 256 threads each owning a 4x4 register micro-tile of scores and of the
// output accumulator (tile layout in graphit_tile.cuh).
//
// Grid: one block per (b, query tile, h), h fastest. Blocks on the GPU run
// in no fixed order, so the TPU's trick of keeping the pe tile resident
// across an inner head axis does not carry over. Instead the H blocks that
// read the same pe rows are adjacent in launch order and the pe tile they
// share comes from L2 (50 MB holds the whole [B, N, N] pe at B=8, N=1024).
// Ragged N is handled by masking the edge tiles: keys >= N get e = 0 and
// never enter m, queries >= N are not stored.
//
// C interface (ctypes): pointers and the stream as void*, returns the
// cudaError_t of the launch.

#include <cuda_runtime.h>
#include <math.h>

#include "graphit_tile.cuh"

namespace {

using namespace graphit;

constexpr int kMaxDV = 64;
constexpr int kVals = kMaxDV / kTX;  // value columns per thread

__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ xa, const float* __restrict__ x,
                 const float* __restrict__ cq, const float* __restrict__ ck,
                 const float* __restrict__ c0, const float* __restrict__ vw,
                 const float* __restrict__ pe, const float* __restrict__ deg,
                 const float* __restrict__ mask, float* __restrict__ outh,
                 float* __restrict__ m_out, float* __restrict__ se_out,
                 float* __restrict__ su_out, int H, int N, int D, int DV,
                 float inv_sqrt) {
  extern __shared__ float smem[];
  float* xaT = smem;                    // [D][kLDQ]  query tile, transposed
  float* xT = xaT + D * kLDQ;           // [D][kLDK]  key tile, transposed
  float* vws = xT + D * kLDK;           // [kBK][DV]
  float* ps = vws + kBK * DV;           // [kBQ][kLDK] pe tile, then P
  float* cks = ps + kBQ * kLDK;         // [kBK]
  float* dgs = cks + kBK;               // [kBK]
  float* kms = dgs + kBK;               // [kBK]

  const int nq = (N + kBQ - 1) / kBQ;
  int bid = blockIdx.x;
  const int h = bid % H;
  bid /= H;
  const int q0 = (bid % nq) * kBQ;
  const int b = bid / nq;
  const int tid = threadIdx.x;
  const int tx = tid % kTX;
  const int ty = tid / kTX;

  const size_t bh = (size_t)b * H + h;
  const float* xa_bh = xa + bh * N * D;
  const float* x_b = x + (size_t)b * N * D;
  const float* vw_bh = vw + bh * N * DV;
  const float* pe_b = pe ? pe + (size_t)b * N * N : nullptr;
  const float* mask_b = mask + (size_t)b * N;
  const float* cq_bh = cq + bh * N;
  const float* ck_bh = ck + bh * N;

  stage_transposed(xaT, kLDQ, xa_bh, q0, N, D, tid);
  float cqr[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int q = q0 + ty + kTY * i;
    cqr[i] = q < N ? cq_bh[q] : 0.f;
  }
  const float c0h = c0[h];

  float m_r[kRows], se_r[kRows], su_r[kRows], scale_r[kRows];
  float acc[kRows][kVals];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m_r[i] = -INFINITY;
    se_r[i] = 0.f;
    su_r[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kVals; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = 0; k0 < N; k0 += kBK) {
    __syncthreads();  // the previous tile's readers are done
    stage_transposed(xT, kLDK, x_b, k0, N, D, tid);
    for (int i = tid; i < kBK * DV; i += kThreads) {
      const int c = i / DV, v = i % DV, key = k0 + c;
      vws[i] = key < N ? vw_bh[(size_t)key * DV + v] : 0.f;
    }
    for (int i = tid; i < kBQ * kBK; i += kThreads) {
      const int r = i / kBK, c = i % kBK, q = q0 + r, key = k0 + c;
      float p = 0.f;
      if (q < N && key < N) p = pe_b ? pe_b[(size_t)q * N + key] : 1.f;
      ps[r * kLDK + c] = p;
    }
    if (tid < kBK) {
      const int key = k0 + tid;
      const bool in = key < N;
      cks[tid] = in ? ck_bh[key] : 0.f;
      dgs[tid] = in ? (deg ? deg[(size_t)b * N + key] : 1.f) : 0.f;
      kms[tid] = in ? mask_b[key] : 0.f;
    }
    __syncthreads();

    float s[kRows][kCols];
    tile_dot(xaT, xT, D, tx, ty, s);

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = ty + kTY * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int c = tx + kTX * j;
        float v = score(s[i][j], cqr[i], cks[c], c0h, inv_sqrt, kms[c]);
        if (k0 + c >= N) v = -INFINITY;  // beyond the ragged edge
        s[i][j] = v;
        mx = fmaxf(mx, v);
      }
      // the 16 threads sharing row r are 16 consecutive lanes of a warp
#pragma unroll
      for (int off = kTX / 2; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_r[i], mx);
      const float scale = expf(m_r[i] - m_new);  // 0 on the first tile
      float es = 0.f, ws = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int c = tx + kTX * j;
        const float e = expf(s[i][j] - m_new);
        const float w = e * (ps[r * kLDK + c] * dgs[c]);
        es += e;
        ws += w;
        ps[r * kLDK + c] = w * kms[c];  // only this thread touches (r, c)
      }
#pragma unroll
      for (int off = kTX / 2; off > 0; off >>= 1) {
        es += __shfl_xor_sync(0xffffffffu, es, off);
        ws += __shfl_xor_sync(0xffffffffu, ws, off);
      }
      se_r[i] = se_r[i] * scale + es;
      su_r[i] = su_r[i] * scale + ws;
      m_r[i] = m_new;
      scale_r[i] = scale;
    }
    __syncthreads();  // P complete

    float part[kRows][kVals] = {};  // this key tile's P·V
    for (int c = 0; c < kBK; ++c) {
      float p[kRows], vv[kVals];
#pragma unroll
      for (int i = 0; i < kRows; ++i) p[i] = ps[(ty + kTY * i) * kLDK + c];
#pragma unroll
      for (int j = 0; j < kVals; ++j) {
        const int v = tx + kTX * j;
        vv[j] = v < DV ? vws[c * DV + v] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kVals; ++j)
          part[i][j] = fmaf(p[i], vv[j], part[i][j]);
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kVals; ++j)
        acc[i][j] = fmaf(acc[i][j], scale_r[i], part[i][j]);
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int q = q0 + ty + kTY * i;
    if (q >= N) continue;
    const float se = se_r[i], su = su_r[i];
    const float div = fabsf(su / se) > kEps ? su : se;
    const float qm = mask_b[q];
    const size_t row = bh * N + q;
#pragma unroll
    for (int j = 0; j < kVals; ++j) {
      const int v = tx + kTX * j;
      if (v < DV) outh[row * DV + v] = acc[i][j] / div * qm;
    }
    if (tx == 0) {
      m_out[row] = m_r[i];
      se_out[row] = se;
      su_out[row] = su;
    }
  }
}

size_t smem_bytes(int D, int DV) {
  return sizeof(float) * ((size_t)D * kLDQ + (size_t)D * kLDK +
                          (size_t)kBK * DV + (size_t)kBQ * kLDK + 3 * kBK);
}

}  // namespace

extern "C" int feta_flash_fwd(const void* xa, const void* x, const void* cq,
                              const void* ck, const void* c0, const void* vw,
                              const void* pe, const void* deg,
                              const void* mask, void* outh, void* m, void* se,
                              void* su, int B, int H, int N, int D, int DV,
                              float inv_sqrt, void* stream) {
  if (B <= 0 || H <= 0 || N <= 0 || D <= 0 || DV <= 0 || DV > kMaxDV)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(D, DV);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int nq = (N + kBQ - 1) / kBQ;
  flash_fwd_kernel<<<B * H * nq, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)xa, (const float*)x, (const float*)cq, (const float*)ck,
      (const float*)c0, (const float*)vw, (const float*)pe,
      (const float*)deg, (const float*)mask, (float*)outh, (float*)m,
      (float*)se, (float*)su, H, N, D, DV, inv_sqrt);
  return (int)cudaGetLastError();
}

extern "C" const char* feta_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
