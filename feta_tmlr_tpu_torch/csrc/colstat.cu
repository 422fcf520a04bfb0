// Detached attention column statistics, f32, for sm_90a.
//
// Replaces the TPU kernel feta_tmlr_tpu/ops/pallas/flash_attention.py
// `_colstat_kernel` (launched by `_call_colstat`). From the row statistics
// (m, se, su) that flash_fwd.cu emitted it recomputes the normalised,
// masked attention of one (graph b, head h)
//
//   attn[i,j] = exp(s[i,j] - m[i]) / se[i] * pd[i,j] * qmask[i] / safe[i]
//               * kmask[j],      safe[i] = |su/se| > 1e-9 ? su/se : 1
//
// with s (graphit_tile.cuh) and pd as in flash_fwd.cu, and writes per key
// column j
//
//   colsum[j] = sum_i attn[i,j] * wq[i]      (wq absent: 1)
//   diag[j]   = attn[j,j]
//
// The FeTA coefficient head needs gcn_norm_directed(attn) summed over the
// source axis; two launches of this kernel (wq = 1, then wq = deg_in^-1/2)
// give it without an [N, N] tensor in device memory (glue in colstat.py).
//
// What bounds it on the H100: arithmetic, 2·N²·D f32 FMA-flops per (b, h)
// for the recomputed scores on CUDA cores (no TF32); pe is read once per
// graph from memory and the other H-1 times from L2. Design: one block per
// (b, key tile, h), h fastest; the block keeps its 64 keys resident in
// shared memory and loops over ALL query tiles itself, so the column sum
// is finished inside one block: no atomics, and a fixed summation order
// (deterministic). On the TPU the sequential query grid axis played that
// role. The diagonal is read as attn[j, j] by the one thread that holds
// that element, so the tiles need not be square. Ragged N: rows and
// columns beyond N contribute nothing and are not stored.
//
// C interface (ctypes): pointers and the stream as void*, returns the
// cudaError_t of the launch.

#include <cuda_runtime.h>
#include <math.h>

#include "graphit_tile.cuh"

namespace {

using namespace graphit;

__global__ void __launch_bounds__(kThreads)
colstat_kernel(const float* __restrict__ xa, const float* __restrict__ x,
               const float* __restrict__ cq, const float* __restrict__ ck,
               const float* __restrict__ c0, const float* __restrict__ pe,
               const float* __restrict__ deg, const float* __restrict__ mask,
               const float* __restrict__ m, const float* __restrict__ se,
               const float* __restrict__ su, const float* __restrict__ wq,
               float* __restrict__ colsum, float* __restrict__ diag, int H,
               int N, int D, float inv_sqrt) {
  extern __shared__ float smem[];
  float* xT = smem;                     // [D][kLDK]  key tile (resident)
  float* xaT = xT + D * kLDK;           // [D][kLDQ]  query tile
  float* ps = xaT + D * kLDQ;           // [kBQ][kLDK] pe tile; reduction
  float* cks = ps + kBQ * kLDK;         // [kBK]
  float* dgs = cks + kBK;               // [kBK] degree of the key
  float* kms = dgs + kBK;               // [kBK]
  float* diags = kms + kBK;             // [kBK]
  float* cqs = diags + kBK;             // [kBQ]
  float* ms = cqs + kBQ;                // [kBQ]
  float* ises = ms + kBQ;               // [kBQ] 1/se
  float* qas = ises + kBQ;              // [kBQ] qmask/safe
  float* wqs = qas + kBQ;               // [kBQ]

  const int nk = (N + kBK - 1) / kBK;
  int bid = blockIdx.x;
  const int h = bid % H;
  bid /= H;
  const int k0 = (bid % nk) * kBK;
  const int b = bid / nk;
  const int tid = threadIdx.x;
  const int tx = tid % kTX;
  const int ty = tid / kTX;

  const size_t bh = (size_t)b * H + h;
  const float* xa_bh = xa + bh * N * D;
  const float* x_b = x + (size_t)b * N * D;
  const float* pe_b = pe ? pe + (size_t)b * N * N : nullptr;
  const float* mask_b = mask + (size_t)b * N;

  stage_transposed(xT, kLDK, x_b, k0, N, D, tid);
  if (tid < kBK) {
    const int key = k0 + tid;
    const bool in = key < N;
    cks[tid] = in ? ck[bh * N + key] : 0.f;
    dgs[tid] = in ? (deg ? deg[(size_t)b * N + key] : 1.f) : 0.f;
    kms[tid] = in ? mask_b[key] : 0.f;
    diags[tid] = 0.f;
  }
  const float c0h = c0[h];

  float cs[kCols];
#pragma unroll
  for (int j = 0; j < kCols; ++j) cs[j] = 0.f;

  for (int q0 = 0; q0 < N; q0 += kBQ) {
    __syncthreads();
    stage_transposed(xaT, kLDQ, xa_bh, q0, N, D, tid);
    for (int i = tid; i < kBQ * kBK; i += kThreads) {
      const int r = i / kBK, c = i % kBK, q = q0 + r, key = k0 + c;
      float p = 0.f;
      if (q < N && key < N) p = pe_b ? pe_b[(size_t)q * N + key] : 1.f;
      ps[r * kLDK + c] = p;
    }
    if (tid < kBQ) {
      const int q = q0 + tid;
      if (q < N) {
        const size_t row = bh * N + q;
        const float sev = se[row], suv = su[row];
        const float denom = suv / sev;
        const float safe = fabsf(denom) > kEps ? denom : 1.f;
        cqs[tid] = cq[row];
        ms[tid] = m[row];
        ises[tid] = 1.f / sev;
        qas[tid] = mask_b[q] / safe;
        wqs[tid] = wq ? wq[row] : 1.f;
      } else {
        cqs[tid] = 0.f;
        ms[tid] = 0.f;
        ises[tid] = 0.f;
        qas[tid] = 0.f;
        wqs[tid] = 0.f;
      }
    }
    __syncthreads();

    float s[kRows][kCols];
    tile_dot(xaT, xT, D, tx, ty, s);

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = ty + kTY * i;
      if (q0 + r >= N) continue;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int c = tx + kTX * j;
        const float v = score(s[i][j], cqs[r], cks[c], c0h, inv_sqrt, kms[c]);
        const float e = expf(v - ms[r]);
        const float attn = e * ises[r] * (ps[r * kLDK + c] * dgs[c]) *
                           qas[r] * kms[c];
        cs[j] = fmaf(attn, wqs[r], cs[j]);
        if (q0 + r == k0 + c) diags[c] = attn;  // the one holder of (j, j)
      }
    }
  }

  // fixed-order reduction of the 16 per-thread partial sums of a column
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kCols; ++j) ps[ty * kBK + tx + kTX * j] = cs[j];
  __syncthreads();
  if (tid < kBK && k0 + tid < N) {
    float total = 0.f;
    for (int t = 0; t < kTY; ++t) total += ps[t * kBK + tid];
    colsum[bh * N + k0 + tid] = total;
    diag[bh * N + k0 + tid] = diags[tid];
  }
}

size_t smem_bytes(int D) {
  return sizeof(float) * ((size_t)D * kLDK + (size_t)D * kLDQ +
                          (size_t)kBQ * kLDK + 4 * kBK + 5 * kBQ);
}

}  // namespace

extern "C" int feta_colstat(const void* xa, const void* x, const void* cq,
                            const void* ck, const void* c0, const void* pe,
                            const void* deg, const void* mask, const void* m,
                            const void* se, const void* su, const void* wq,
                            void* colsum, void* diag, int B, int H, int N,
                            int D, float inv_sqrt, void* stream) {
  if (B <= 0 || H <= 0 || N <= 0 || D <= 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(
      colstat_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int nk = (N + kBK - 1) / kBK;
  colstat_kernel<<<B * H * nk, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)xa, (const float*)x, (const float*)cq, (const float*)ck,
      (const float*)c0, (const float*)pe, (const float*)deg,
      (const float*)mask, (const float*)m, (const float*)se,
      (const float*)su, (const float*)wq, (float*)colsum, (float*)diag, H, N,
      D, inv_sqrt);
  return (int)cudaGetLastError();
}

extern "C" const char* feta_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
