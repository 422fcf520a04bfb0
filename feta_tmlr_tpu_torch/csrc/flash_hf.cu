// Head-folded online-softmax GraphiT attention, forward and backward, f32,
// for sm_90a.
//
// Replaces the three head-folded TPU kernels of
// feta_tmlr_tpu/ops/pallas/flash_attention.py (FETA_FLASH_HEAD_FOLD=1):
// `_fwd_kernel_hf` (launched by `_call_fwd_hf`), `_bwd_q_kernel_hf` and
// `_bwd_k_kernel_hf` (both launched by `_call_bwd_hf`). Each computes what
// its unfolded twin computes (flash_fwd.cu, flash_bwd.cu; the formulas are
// in their notes and in graphit_tile.cuh's `score` / `grad_score`):
//
//   flash_fwd_hf_kernel:    outh_h, m, se, su  for every head h
//   flash_bwd_q_hf_kernel:  dxa_h = ds_h @ x,        dcq_h = sum_j ds_h
//   flash_bwd_k_hf_kernel:  dvw_h = attn_h^T @ g_h,  dck_h = sum_i ds_h,
//                           dx    = sum_h ds_h^T @ xa_h
//
// The difference is the work of one block: it owns one (graph, query tile)
// or (graph, key tile) for ALL H heads. The TPU kernel loops over the heads
// inside the program; here the heads run side by side, one group of 64
// threads (two warps) per head, H <= 8 groups in a block of 64·H threads.
// Per tile of the other axis the block stages what the heads share once:
// the x tile, the pe·deg tile and the key mask (the TPU's reason to fold);
// each group stages nothing of its own but reads its head's xa, vw, g and
// row constants from the block's shared tiles.
//
// Order: key tile outer, heads side by side inner. The other order (head
// outer, key tile inner) keeps one head's state but would read the pe tile
// once per head and leave a block working on one head at a time; the
// side-by-side order keeps every head's running state in its own group's
// registers, so no head waits for another.
//
// What bounds them on the H100: arithmetic, as their twins
// (2·N²·(D + DV) FMA-flops per (b, h) forward, 2·N²·(2D + DV) and
// 2·N²·(2D + 2DV) for the two passes, CUDA cores in full f32 against 67
// TFLOP/s). And parallelism: with one block per (graph, 64-row tile) the
// folded grid would be B·N/64 blocks, 32 at the training shape (B=1,
// N=2048) on 132 SMs. The tiles are
// therefore 16 rows wide on the axis the block owns: B·N/16 blocks (128 at
// B=1, N=2048; 256 at the serving B=2), each of 512 threads at H=8, the
// same threads per SM as the unfolded grid. Each thread keeps the unfolded
// kernels' 4x4 register micro-tiles: rows ty + 4 i of its group's 16, keys
// or columns tx + 16 j. Shared memory (at H=8, D=DV=64): forward 222 KB
// (16 queries x 64 keys), q pass 166 KB (16 x 32), k pass 131 KB (16 keys
// x 16 queries): one block per SM, which the 512 threads' registers (128
// each, `__launch_bounds__(512, 1)`) allow anyway.
//
// The k pass sums dx over the heads inside the block: each group keeps its
// head's dx rows in registers over all query tiles, then writes them to
// shared memory, and the block adds the H partials in the fixed order
// 0..H-1, as flash_bwd.cu's head_sum_kernel does, with no [B, H, N, D]
// partials in device memory and no second launch. dck sums its column over
// the 4 row groups in a fixed order too. No float atomics anywhere: every
// gradient is bit-identical from run to run.
//
// The cotangent g is per head, [B, H, N, DV]. On the unfiltered layers
// every head gets the same g (the head sum's cotangent is expanded) and the
// caller makes it contiguous (FlashGraphiT.backward), so the kernel reads
// one g per head whatever the layer.
//
// Ragged N: keys >= N get e = 0 (score -inf) and never enter m, rows and
// keys >= N contribute exactly 0 and are not stored; padded queries inside
// N have qa = 0 (and a masked output), as in the unfolded kernels.
//
// C interface (ctypes): pointers and the stream as void*, returns the
// cudaError_t of the launch.

#include <cuda_runtime.h>
#include <math.h>

#include "graphit_tile.cuh"

namespace {

using graphit::grad_score;
using graphit::kEps;
using graphit::score;

constexpr int kGX = 16;                   // lanes along keys / columns
constexpr int kGY = 4;                    // lanes along rows
constexpr int kGroup = kGX * kGY;         // threads of one head
constexpr int kMaxHeads = 8;
constexpr int kMaxThreads = kGroup * kMaxHeads;
constexpr int kMaxW = 64;                 // D and DV at most 64
constexpr int kOut = kMaxW / kGX;         // output columns per thread
constexpr int kRows = 4;                  // rows per thread: 16-row tiles
constexpr int kTile = kGY * kRows;        // 16
constexpr int kLD16 = kTile + 1;          // padded strides
// forward: 16 queries x 64 keys; q pass: 16 x 32; k pass: 16 keys x 16
constexpr int kFK = 64, kLDF = kFK + 1;
constexpr int kFC = kFK / kGX;         // key columns per thread, forward
constexpr int kQK = 32, kLDQ = kQK + 1;

struct Operands {
  const float *xa, *x, *cq, *ck, *c0, *vw, *pe, *deg, *mask, *g;
  const float *m, *ise, *qa, *beta, *c;
};

constexpr int kBatch = 4;   // float4 loads in flight per thread, staging

// Copies the `rows` rows (from row0) of every head's [N, w] slab of `src`
// (H slabs; H = 1 for an operand without heads: pass the graph's base
// pointer) into shared memory, zero beyond the ragged edge N:
//   kTransposed: dst[(h * w + k) * ld + r],
//   natural:     dst[(h * rows + r) * w + k].
// A block staging alone on its SM waits for these loads, so each thread
// keeps kBatch 16-byte loads in flight before it stores any (4-byte loads
// one at a time where w or the pointer does not allow 16 bytes).
template <bool kTransposed>
__device__ __forceinline__ void stage(float* dst, int ld, const float* src,
                                      int H, int row0, int rows, int N,
                                      int w) {
  const int vec = (w % 4 == 0 && reinterpret_cast<size_t>(src) % 16 == 0)
                      ? 4 : 1;
  const int wv = w / vec, per = rows * wv, total = H * per;
  for (int base = threadIdx.x; base < total; base += blockDim.x * kBatch) {
    float v[kBatch][4];
    int at[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = base + u * blockDim.x;
      at[u] = -1;
      if (i >= total) continue;
      const int h = i / per, rest = i - h * per, r = rest / wv;
      const int k = (rest - r * wv) * vec, row = row0 + r;
      at[u] = kTransposed ? (h * w + k) * ld + r : (h * rows + r) * w + k;
      const float* p = src + ((size_t)h * N + row) * w + k;
      if (row >= N) {
        v[u][0] = v[u][1] = v[u][2] = v[u][3] = 0.f;
      } else if (vec == 4) {
        const float4 q = *reinterpret_cast<const float4*>(p);
        v[u][0] = q.x, v[u][1] = q.y, v[u][2] = q.z, v[u][3] = q.w;
      } else {
        v[u][0] = *p;
      }
    }
    const int step = kTransposed ? ld : 1;
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (at[u] < 0) continue;
      dst[at[u]] = v[u][0];
      if (vec == 4) {
        dst[at[u] + step] = v[u][1];
        dst[at[u] + 2 * step] = v[u][2];
        dst[at[u] + 3 * step] = v[u][3];
      }
    }
  }
}

// pd[r * ld + c] = pe[q0 + r, k0 + c] * deg[k0 + c] (1 where absent), zero
// beyond the ragged edge.
__device__ __forceinline__ void stage_pd(float* pd, int ld, const float* pe_b,
                                         const float* deg_b, int q0, int nr,
                                         int k0, int nc, int N) {
  for (int i = threadIdx.x; i < nr * nc; i += blockDim.x) {
    const int r = i / nc, c = i % nc, q = q0 + r, key = k0 + c;
    float p = 0.f;
    if (q < N && key < N)
      p = (pe_b ? pe_b[(size_t)q * N + key] : 1.f) *
          (deg_b ? deg_b[key] : 1.f);
    pd[r * ld + c] = p;
  }
}

// ck of every head and the key mask for keys k0 .. k0 + nc - 1.
__device__ __forceinline__ void stage_key_vectors(float* cks, float* kms,
                                                  const float* ck_b,
                                                  const float* mask_b, int H,
                                                  int k0, int nc, int N) {
  for (int i = threadIdx.x; i < H * nc; i += blockDim.x) {
    const int h = i / nc, key = k0 + i % nc;
    cks[i] = key < N ? ck_b[(size_t)h * N + key] : 0.f;
    if (h == 0) kms[i] = key < N ? mask_b[key] : 0.f;
  }
}

// s[i][j] = sum_k aT[k * lda + ty + 4 i] * bT[k * ldb + tx + 16 j]
template <int R, int C>
__device__ __forceinline__ void micro_dot(const float* aT, int lda,
                                          const float* bT, int ldb, int K,
                                          int tx, int ty, float (&s)[R][C]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < C; ++j) s[i][j] = 0.f;
  for (int k = 0; k < K; ++k) {
    float a[R], b[C];
#pragma unroll
    for (int i = 0; i < R; ++i) a[i] = aT[k * lda + ty + kGY * i];
#pragma unroll
    for (int j = 0; j < C; ++j) b[j] = bT[k * ldb + tx + kGX * j];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < C; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
  }
}

// the 16 threads of a row are 16 consecutive lanes of one warp
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int off = kGX / 2; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__global__ void __launch_bounds__(kMaxThreads, 1)
flash_fwd_hf_kernel(Operands op, float* __restrict__ outh,
                    float* __restrict__ m_out, float* __restrict__ se_out,
                    float* __restrict__ su_out, int H, int N, int D, int DV,
                    float inv_sqrt) {
  extern __shared__ float smem[];
  float* xaT = smem;                     // [H][D][kLD16]   query tiles
  float* xT = xaT + H * D * kLD16;       // [D][kLDF]       key tile
  float* vws = xT + D * kLDF;            // [H][kFK][DV]    its values
  float* pds = vws + H * kFK * DV;       // [kTile][kLDF]   pe * deg
  float* ps = pds + kTile * kLDF;        // [H][kTile][kLDF] P
  float* cks = ps + H * kTile * kLDF;    // [H][kFK]
  float* kms = cks + H * kFK;            // [kFK]

  const int nq = (N + kTile - 1) / kTile;
  const int q0 = (blockIdx.x % nq) * kTile;
  const int b = blockIdx.x / nq;
  const int h = threadIdx.x / kGroup;
  const int lt = threadIdx.x % kGroup;
  const int tx = lt % kGX, ty = lt / kGX;

  const size_t bh = (size_t)b * H + h;
  const float* pe_b = op.pe ? op.pe + (size_t)b * N * N : nullptr;
  const float* deg_b = op.deg ? op.deg + (size_t)b * N : nullptr;
  const float* mask_b = op.mask + (size_t)b * N;
  const float* hxaT = xaT + h * D * kLD16;
  const float* hvw = vws + h * kFK * DV;
  float* hps = ps + h * kTile * kLDF;
  const float* hck = cks + h * kFK;

  stage<true>(xaT, kLD16, op.xa + (size_t)b * H * N * D, H, q0, kTile, N, D);
  float cqr[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int q = q0 + ty + kGY * i;
    cqr[i] = q < N ? op.cq[bh * N + q] : 0.f;
  }
  const float c0h = op.c0[h];

  float m_r[kRows], se_r[kRows], su_r[kRows], scale_r[kRows];
  float acc[kRows][kOut];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m_r[i] = -INFINITY;
    se_r[i] = su_r[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kOut; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = 0; k0 < N; k0 += kFK) {
    __syncthreads();  // the previous tile's readers are done
    stage<true>(xT, kLDF, op.x + (size_t)b * N * D, 1, k0, kFK, N, D);
    stage<false>(vws, 0, op.vw + (size_t)b * H * N * DV, H, k0, kFK, N, DV);
    stage_pd(pds, kLDF, pe_b, deg_b, q0, kTile, k0, kFK, N);
    stage_key_vectors(cks, kms, op.ck + (size_t)b * H * N, mask_b, H, k0,
                      kFK, N);
    __syncthreads();

    float s[kRows][kFC];
    micro_dot(hxaT, kLD16, xT, kLDF, D, tx, ty, s);
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = ty + kGY * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < kFC; ++j) {
        const int c = tx + kGX * j;
        float v = score(s[i][j], cqr[i], hck[c], c0h, inv_sqrt, kms[c]);
        if (k0 + c >= N) v = -INFINITY;  // beyond the ragged edge
        s[i][j] = v;
        mx = fmaxf(mx, v);
      }
#pragma unroll
      for (int off = kGX / 2; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_r[i], mx);
      const float scale = expf(m_r[i] - m_new);  // 0 on the first tile
      float es = 0.f, ws = 0.f;
#pragma unroll
      for (int j = 0; j < kFC; ++j) {
        const int c = tx + kGX * j;
        const float e = expf(s[i][j] - m_new);
        const float w = e * pds[r * kLDF + c];
        es += e;
        ws += w;
        hps[r * kLDF + c] = w * kms[c];  // only this thread touches (r, c)
      }
      se_r[i] = se_r[i] * scale + row_sum(es);
      su_r[i] = su_r[i] * scale + row_sum(ws);
      m_r[i] = m_new;
      scale_r[i] = scale;
    }
    __syncthreads();  // P complete

    float part[kRows][kOut] = {};  // this key tile's P·V
    for (int c = 0; c < kFK; ++c) {
      float p[kRows], vv[kOut];
#pragma unroll
      for (int i = 0; i < kRows; ++i) p[i] = hps[(ty + kGY * i) * kLDF + c];
#pragma unroll
      for (int j = 0; j < kOut; ++j) {
        const int v = tx + kGX * j;
        vv[j] = v < DV ? hvw[c * DV + v] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kOut; ++j)
          part[i][j] = fmaf(p[i], vv[j], part[i][j]);
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kOut; ++j)
        acc[i][j] = fmaf(acc[i][j], scale_r[i], part[i][j]);
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int q = q0 + ty + kGY * i;
    if (q >= N) continue;
    const float se = se_r[i], su = su_r[i];
    const float div = fabsf(su / se) > kEps ? su : se;
    const float qm = mask_b[q];
    const size_t row = bh * N + q;
#pragma unroll
    for (int j = 0; j < kOut; ++j) {
      const int v = tx + kGX * j;
      if (v < DV) outh[row * DV + v] = acc[i][j] / div * qm;
    }
    if (tx == 0) {
      m_out[row] = m_r[i];
      se_out[row] = se;
      su_out[row] = su;
    }
  }
}

constexpr int kQC = kQK / kGX;  // key columns per thread in the q pass

__global__ void __launch_bounds__(kMaxThreads, 1)
flash_bwd_q_hf_kernel(Operands op, float* __restrict__ dxa,
                      float* __restrict__ dcq, int H, int N, int D, int DV,
                      float inv_sqrt) {
  extern __shared__ float smem[];
  float* xaT = smem;                     // [H][D][kLD16]   query tiles
  float* gT = xaT + H * D * kLD16;       // [H][DV][kLD16]  their cotangents
  float* xT = gT + H * DV * kLD16;       // [D][kLDQ]       key tile
  float* vwT = xT + D * kLDQ;            // [H][DV][kLDQ]   its values
  float* pds = vwT + H * DV * kLDQ;      // [kTile][kLDQ]   pe * deg
  float* dss = pds + kTile * kLDQ;       // [H][kTile][kLDQ] ds
  float* cks = dss + H * kTile * kLDQ;   // [H][kQK]
  float* kms = cks + H * kQK;            // [kQK]

  const int nq = (N + kTile - 1) / kTile;
  const int q0 = (blockIdx.x % nq) * kTile;
  const int b = blockIdx.x / nq;
  const int h = threadIdx.x / kGroup;
  const int lt = threadIdx.x % kGroup;
  const int tx = lt % kGX, ty = lt / kGX;

  const size_t bh = (size_t)b * H + h;
  const float* pe_b = op.pe ? op.pe + (size_t)b * N * N : nullptr;
  const float* deg_b = op.deg ? op.deg + (size_t)b * N : nullptr;
  const float* mask_b = op.mask + (size_t)b * N;
  const float* hxaT = xaT + h * D * kLD16;
  const float* hgT = gT + h * DV * kLD16;
  const float* hvwT = vwT + h * DV * kLDQ;
  float* hds = dss + h * kTile * kLDQ;
  const float* hck = cks + h * kQK;

  stage<true>(xaT, kLD16, op.xa + (size_t)b * H * N * D, H, q0, kTile, N, D);
  stage<true>(gT, kLD16, op.g + (size_t)b * H * N * DV, H, q0, kTile, N, DV);
  float cq_r[kRows], m_r[kRows], ise_r[kRows], qa_r[kRows], beta_r[kRows],
      c_r[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int q = q0 + ty + kGY * i;
    const bool in = q < N;
    const size_t row = bh * N + q;
    cq_r[i] = in ? op.cq[row] : 0.f;
    m_r[i] = in ? op.m[row] : 0.f;
    ise_r[i] = in ? op.ise[row] : 0.f;
    qa_r[i] = in ? op.qa[row] : 0.f;
    beta_r[i] = in ? op.beta[row] : 0.f;
    c_r[i] = in ? op.c[row] : 0.f;
  }
  const float c0h = op.c0[h];

  float acc[kRows][kOut], dsum[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    dsum[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kOut; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = 0; k0 < N; k0 += kQK) {
    __syncthreads();  // the previous tile's readers are done
    stage<true>(xT, kLDQ, op.x + (size_t)b * N * D, 1, k0, kQK, N, D);
    stage<true>(vwT, kLDQ, op.vw + (size_t)b * H * N * DV, H, k0, kQK, N, DV);
    stage_pd(pds, kLDQ, pe_b, deg_b, q0, kTile, k0, kQK, N);
    stage_key_vectors(cks, kms, op.ck + (size_t)b * H * N, mask_b, H, k0,
                      kQK, N);
    __syncthreads();

    float s[kRows][kQC], ga[kRows][kQC];
    micro_dot(hxaT, kLD16, xT, kLDQ, D, tx, ty, s);
    micro_dot(hgT, kLD16, hvwT, kLDQ, DV, tx, ty, ga);
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = ty + kGY * i;
#pragma unroll
      for (int j = 0; j < kQC; ++j) {
        const int c = tx + kGX * j;
        float d = 0.f, attn = 0.f;
        if (q0 + r < N && k0 + c < N)
          d = grad_score(s[i][j], cq_r[i], hck[c], c0h, inv_sqrt, kms[c],
                         m_r[i], ise_r[i], qa_r[i], beta_r[i], c_r[i],
                         pds[r * kLDQ + c], ga[i][j], attn);
        dsum[i] += d;
        hds[r * kLDQ + c] = d;  // only this thread touches (r, c)
      }
    }
    __syncthreads();  // ds complete

    // dxa[r, k] += sum_c ds[r, c] * x[c, k]; x read from its transposed
    // tile; the tile's sum into a fresh partial (flash_fwd.cu's note)
    float part[kRows][kOut] = {};
    for (int c = 0; c < kQK; ++c) {
      float p[kRows], xv[kOut];
#pragma unroll
      for (int i = 0; i < kRows; ++i) p[i] = hds[(ty + kGY * i) * kLDQ + c];
#pragma unroll
      for (int j = 0; j < kOut; ++j) {
        const int k = tx + kGX * j;
        xv[j] = k < D ? xT[k * kLDQ + c] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kOut; ++j)
          part[i][j] = fmaf(p[i], xv[j], part[i][j]);
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kOut; ++j) acc[i][j] += part[i][j];
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const float total = row_sum(dsum[i]);
    const int q = q0 + ty + kGY * i;
    if (q >= N) continue;
    const size_t row = bh * N + q;
#pragma unroll
    for (int j = 0; j < kOut; ++j) {
      const int k = tx + kGX * j;
      if (k < D) dxa[row * D + k] = acc[i][j];
    }
    if (tx == 0) dcq[row] = total;
  }
}

__global__ void __launch_bounds__(kMaxThreads, 1)
flash_bwd_k_hf_kernel(Operands op, float* __restrict__ dvw,
                      float* __restrict__ dck, float* __restrict__ dx, int H,
                      int N, int D, int DV, float inv_sqrt) {
  extern __shared__ float smem[];
  float* xT = smem;                      // [D][kLD16]      key tile
  float* vwT = xT + D * kLD16;           // [H][DV][kLD16]  its values
  float* xaT = vwT + H * DV * kLD16;     // [H][D][kLD16]   query tiles
  float* gT = xaT + H * D * kLD16;       // [H][DV][kLD16]  their cotangents
  float* pds = gT + H * DV * kLD16;      // [kTile][kLD16]  pe * deg
  float* ats = pds + kTile * kLD16;      // [H][kTile][kLD16] attn
  float* dss = ats + H * kTile * kLD16;  // [H][kTile][kLD16] ds
  float* rcs = dss + H * kTile * kLD16;  // [H][6][kTile] row constants
  float* cks = rcs + H * 6 * kTile;      // [H][kTile]
  float* kms = cks + H * kTile;          // [kTile]

  const int nk = (N + kTile - 1) / kTile;
  const int k0 = (blockIdx.x % nk) * kTile;
  const int b = blockIdx.x / nk;
  const int h = threadIdx.x / kGroup;
  const int lt = threadIdx.x % kGroup;
  const int tx = lt % kGX, ty = lt / kGX;

  const size_t bh = (size_t)b * H + h;
  const float* pe_b = op.pe ? op.pe + (size_t)b * N * N : nullptr;
  const float* deg_b = op.deg ? op.deg + (size_t)b * N : nullptr;
  const float* mask_b = op.mask + (size_t)b * N;
  const float* hvwT = vwT + h * DV * kLD16;
  const float* hxaT = xaT + h * D * kLD16;
  const float* hgT = gT + h * DV * kLD16;
  float* hat = ats + h * kTile * kLD16;
  float* hds = dss + h * kTile * kLD16;
  const float* hrc = rcs + h * 6 * kTile;
  const float* const rows[6] = {op.cq, op.m, op.ise, op.qa, op.beta, op.c};

  stage<true>(xT, kLD16, op.x + (size_t)b * N * D, 1, k0, kTile, N, D);
  stage<true>(vwT, kLD16, op.vw + (size_t)b * H * N * DV, H, k0, kTile, N, DV);
  stage_key_vectors(cks, kms, op.ck + (size_t)b * H * N, mask_b, H, k0,
                    kTile, N);
  const float c0h = op.c0[h];

  // key-major accumulators: keys ty + 4 i, columns tx + 16 j
  float acc_v[kRows][kOut], acc_x[kRows][kOut], colsum = 0.f;
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int j = 0; j < kOut; ++j) acc_v[i][j] = acc_x[i][j] = 0.f;

  for (int q0 = 0; q0 < N; q0 += kTile) {
    __syncthreads();  // the previous tile's readers are done
    stage<true>(xaT, kLD16, op.xa + (size_t)b * H * N * D, H, q0, kTile, N, D);
    stage<true>(gT, kLD16, op.g + (size_t)b * H * N * DV, H, q0, kTile, N, DV);
    stage_pd(pds, kLD16, pe_b, deg_b, q0, kTile, k0, kTile, N);
    for (int i = threadIdx.x; i < H * 6 * kTile; i += blockDim.x) {
      const int hh = i / (6 * kTile), which = i / kTile % 6, r = i % kTile;
      const int q = q0 + r;
      rcs[i] = q < N ? rows[which][((size_t)b * H + hh) * N + q] : 0.f;
    }
    __syncthreads();

    // the score tile: queries ty + 4 i, key tx
    float s[kRows][1], ga[kRows][1];
    micro_dot(hxaT, kLD16, xT, kLD16, D, tx, ty, s);
    micro_dot(hgT, kLD16, hvwT, kLD16, DV, tx, ty, ga);
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = ty + kGY * i;
      float d = 0.f, attn = 0.f;
      if (q0 + r < N && k0 + tx < N)
        d = grad_score(s[i][0], hrc[r], cks[h * kTile + tx], c0h, inv_sqrt,
                       kms[tx], hrc[kTile + r], hrc[2 * kTile + r],
                       hrc[3 * kTile + r], hrc[4 * kTile + r],
                       hrc[5 * kTile + r], pds[r * kLD16 + tx], ga[i][0],
                       attn);
      colsum += d;
      hat[r * kLD16 + tx] = attn;  // only this thread touches (r, tx)
      hds[r * kLD16 + tx] = d;
    }
    __syncthreads();  // attn and ds complete

    // dvw[c, v] += sum_r attn[r, c] g[r, v];
    // dx_h[c, k] += sum_r ds[r, c] xa[r, k]
    graphit::add_tile_product<kTile>(acc_v, hat, kLD16, hgT, kLD16, DV, tx,
                                     ty, kGX, kGY);
    graphit::add_tile_product<kTile>(acc_x, hds, kLD16, hxaT, kLD16, D, tx,
                                     ty, kGX, kGY);
  }

  // dvw rows of this head to device memory; each head's dx rows
  // and the column sums of ds to shared memory, over the query tiles and
  // the attn tiles, which nobody reads any more
  __syncthreads();
  float* part = xaT;                     // [H][kTile][D]
  float* red = ats;                      // [H][kGY][kGX]
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int kl = ty + kGY * i, key = k0 + kl;
#pragma unroll
    for (int j = 0; j < kOut; ++j) {
      const int col = tx + kGX * j;
      if (col < DV && key < N) dvw[(bh * N + key) * DV + col] = acc_v[i][j];
      if (col < D) part[(h * kTile + kl) * D + col] = acc_x[i][j];
    }
  }
  red[(h * kGY + ty) * kGX + tx] = colsum;
  __syncthreads();
  if (ty == 0 && k0 + tx < N) {  // dck: the 4 row groups in a fixed order
    float total = 0.f;
    for (int t = 0; t < kGY; ++t) total += red[(h * kGY + t) * kGX + tx];
    dck[bh * N + k0 + tx] = total;
  }
  // dx[key, col] = sum_h part[h, key, col], heads added in order 0..H-1
  for (int i = threadIdx.x; i < kTile * D; i += blockDim.x) {
    const int kl = i / D, col = i % D;
    if (k0 + kl >= N) continue;
    float total = 0.f;
    for (int hh = 0; hh < H; ++hh) total += part[(hh * kTile + kl) * D + col];
    dx[((size_t)b * N + k0 + kl) * D + col] = total;
  }
}

size_t smem_fwd(int H, int D, int DV) {
  return sizeof(float) *
         ((size_t)H * D * kLD16 + (size_t)D * kLDF + (size_t)H * kFK * DV +
          (size_t)kTile * kLDF + (size_t)H * kTile * kLDF +
          (size_t)H * kFK + kFK);
}

size_t smem_q(int H, int D, int DV) {
  return sizeof(float) *
         ((size_t)H * (D + DV) * kLD16 + (size_t)D * kLDQ +
          (size_t)H * DV * kLDQ + (size_t)kTile * kLDQ +
          (size_t)H * kTile * kLDQ + (size_t)H * kQK + kQK);
}

size_t smem_k(int H, int D, int DV) {
  return sizeof(float) *
         ((size_t)(D + H * DV + H * D + H * DV) * kLD16 +
          (size_t)kTile * kLD16 + 2 * (size_t)H * kTile * kLD16 +
          (size_t)H * 6 * kTile + (size_t)H * kTile + kTile);
}

bool bad_shape(int B, int H, int N, int D, int DV) {
  return B <= 0 || H <= 0 || H > kMaxHeads || N <= 0 || D <= 0 ||
         D > kMaxW || DV <= 0 || DV > kMaxW;
}

Operands operands(const void* xa, const void* x, const void* cq,
                  const void* ck, const void* c0, const void* vw,
                  const void* pe, const void* deg, const void* mask,
                  const void* g, const void* m, const void* ise,
                  const void* qa, const void* beta, const void* c) {
  return Operands{(const float*)xa,   (const float*)x,   (const float*)cq,
                  (const float*)ck,   (const float*)c0,  (const float*)vw,
                  (const float*)pe,   (const float*)deg, (const float*)mask,
                  (const float*)g,    (const float*)m,   (const float*)ise,
                  (const float*)qa,   (const float*)beta, (const float*)c};
}

}  // namespace

extern "C" int feta_flash_fwd_hf(const void* xa, const void* x,
                                 const void* cq, const void* ck,
                                 const void* c0, const void* vw,
                                 const void* pe, const void* deg,
                                 const void* mask, void* outh, void* m,
                                 void* se, void* su, int B, int H, int N,
                                 int D, int DV, float inv_sqrt,
                                 void* stream) {
  if (bad_shape(B, H, N, D, DV)) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_fwd(H, D, DV);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_hf_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int nq = (N + kTile - 1) / kTile;
  flash_fwd_hf_kernel<<<B * nq, kGroup * H, smem, (cudaStream_t)stream>>>(
      operands(xa, x, cq, ck, c0, vw, pe, deg, mask, nullptr, nullptr,
               nullptr, nullptr, nullptr, nullptr),
      (float*)outh, (float*)m, (float*)se, (float*)su, H, N, D, DV,
      inv_sqrt);
  return (int)cudaGetLastError();
}

extern "C" int feta_flash_bwd_q_hf(const void* xa, const void* x,
                                   const void* cq, const void* ck,
                                   const void* c0, const void* vw,
                                   const void* pe, const void* deg,
                                   const void* mask, const void* g,
                                   const void* m, const void* ise,
                                   const void* qa, const void* beta,
                                   const void* c, void* dxa, void* dcq,
                                   int B, int H, int N, int D, int DV,
                                   float inv_sqrt, void* stream) {
  if (bad_shape(B, H, N, D, DV)) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_q(H, D, DV);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_q_hf_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int nq = (N + kTile - 1) / kTile;
  flash_bwd_q_hf_kernel<<<B * nq, kGroup * H, smem, (cudaStream_t)stream>>>(
      operands(xa, x, cq, ck, c0, vw, pe, deg, mask, g, m, ise, qa, beta, c),
      (float*)dxa, (float*)dcq, H, N, D, DV, inv_sqrt);
  return (int)cudaGetLastError();
}

extern "C" int feta_flash_bwd_k_hf(const void* xa, const void* x,
                                   const void* cq, const void* ck,
                                   const void* c0, const void* vw,
                                   const void* pe, const void* deg,
                                   const void* mask, const void* g,
                                   const void* m, const void* ise,
                                   const void* qa, const void* beta,
                                   const void* c, void* dvw, void* dck,
                                   void* dx, int B, int H, int N, int D,
                                   int DV, float inv_sqrt, void* stream) {
  if (bad_shape(B, H, N, D, DV)) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_k(H, D, DV);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_k_hf_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int nk = (N + kTile - 1) / kTile;
  flash_bwd_k_hf_kernel<<<B * nk, kGroup * H, smem, (cudaStream_t)stream>>>(
      operands(xa, x, cq, ck, c0, vw, pe, deg, mask, g, m, ise, qa, beta, c),
      (float*)dvw, (float*)dck, (float*)dx, H, N, D, DV, inv_sqrt);
  return (int)cudaGetLastError();
}

extern "C" const char* feta_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
