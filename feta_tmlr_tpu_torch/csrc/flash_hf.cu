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
//                           dx    = sum_h ds_h^T @ xa_h  (tensor cores)
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
// (2·N²·(D + DV) flops per (b, h) forward, 2·N²·(2D + DV) and
// 2·N²·(2D + 2DV) for the two passes). And parallelism: with one block per
// (graph, 64-row tile) the folded grid would be B·N/64 blocks, 32 at the
// training shape (B=1, N=2048) on 132 SMs.
//
// The forward runs on CUDA cores in full f32 against 67 TFLOP/s. Its
// tiles are 16 rows wide on the axis the block owns: B·N/16 blocks (128 at
// B=1, N=2048; 256 at the serving B=2), each of 512 threads at H=8, the
// same threads per SM as the unfolded grid. Each thread keeps the unfolded
// kernels' 4x4 register micro-tiles: rows ty + 4 i of its group's 16, keys
// or columns tx + 16 j. Shared memory (at H=8, D=DV=64): 222 KB (16
// queries x 64 keys): one block per SM, which the 512 threads' registers
// (128 each, `__launch_bounds__(512, 1)`) allow anyway.
//
// The q pass is bwd_q.cuh's kernel on the folded grid (its note): one block
// per (graph, 16-query tile) for all heads, two warps a head over 32-key
// tiles, the score as the forward's FMA chain, ga and dxa on the tensor
// cores in 3xTF32; 184 KB of shared memory at H=8, one block per SM.
//
// The k pass takes its score as the forward's FMA chain and its other
// products on the tensor cores in error-compensated TF32 (mma_tf32.cuh;
// the design in its section below): one block per
// (graph, 32-key tile, query split) for all heads, two warps a head, 8-query
// tiles staged by cp.async into a two-stage ring, 176 KB of shared memory
// at H=8. L2 traffic: each block re-reads xa and g of all heads for the
// queries it loops over, N·H·(D + DV)·4 = 8.4 MB a key tile at B=1,
// N=2048, H=8, D=DV=64. With 16-key blocks over all queries that was 128
// x 8.4 = 1.07 GB a launch; 32-key tiles read it 64 times, 537 MB, and
// splitting each key tile's query loop over 2 blocks keeps 128 blocks on
// 132 SMs without adding traffic (the wrapper picks the splits,
// `k_hf_splits`: as many as keep one block an SM, at most 4). The splits'
// partials are summed in split order by a second launch. Like its
// unfolded twin it is bound by instruction issue: mma.sync's TF32 product
// rate, then the splits and the fragment loads (PERF.md).
//
// dx sums over the heads inside the block, as one tensor-core product over
// K = (head, query) in the fixed order of the heads: no [B, H, N, D]
// partials in device memory and no second launch for it. dck sums each
// column over its queries tile by tile into a graphit::RunSum, then the 4
// lanes of a row, in a fixed order. No float atomics anywhere: every
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

#include "bwd_q.cuh"
#include "graphit_tile.cuh"
#include "mma_tf32.cuh"

namespace {

using graphit::dot4;
using graphit::grad_score;
using graphit::kEps;
using graphit::ld4;
using graphit::Operands;
using graphit::operands;
using graphit::RunSum;
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
// forward: 16 queries x 64 keys
constexpr int kFK = 64, kLDF = kFK + 1;
constexpr int kFC = kFK / kGX;         // key columns per thread, forward

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

// ---- the key pass on tensor cores (mma_tf32.cuh) ----
//
// One block per (graph, 32-key tile, query split) for all H heads: 64·H
// threads, two warps per head, warp 2h + u owning head h's keys 16u ..
// 16u + 15. The block loops over its split's 8-query tiles, staged by
// cp.async into a two-stage ring: every head's xa and g rows, the pe tile
// and the row constants, in rows of 64 floats (kLD64).
//
// Per tile, warp (h, u): the score products s^T = x xa_h^T and
// ga^T = vw_h g_h^T (16 keys x 8 queries, one mma n-tile, K = D and DV:
// 4 independent accumulators, the even and odd k-steps apart), the
// elementwise ds and attn, then dvw_h += attn_h^T g_h (16 keys x DV, K =
// the 8 queries: one k-step a column tile). dx needs the sum over heads,
// dx = sum_h ds_h^T xa_h, which is one product over K = (head, query):
// the block's ds^T [32 keys][H x 8] against the stage's xa rows [H x 8]
// [D], an output tile of 16 keys x 8 columns per warp (kTPW tiles where
// there are fewer warps than tiles), the heads added in order 0..H-1 by
// the product's k-steps. No [H, keys, D] partials, no second pass.
constexpr int kKT7 = 32;                 // keys per block
constexpr int kQT7 = 8;                  // queries per tile
constexpr int kLD64 = 68;                // rows of 64 floats, padded
constexpr int kLDT7 = kQT7 + 4;          // a warp's attn^T [16][kLDT7]
constexpr int kLDP7 = kKT7 + 4;          // pe tile [kQT7][kLDP7]
constexpr int kNRC = 6;                  // row constants cq m ise qa beta c
constexpr int kMaxSplits = 4;

__device__ __host__ inline int ld_ds(int H) { return kQT7 * H + 4; }

__device__ __host__ inline size_t k_stage_floats(int H) {
  return 2 * (size_t)H * kQT7 * kLD64 + kQT7 * kLDP7 +
         (size_t)H * kNRC * kQT7;
}

__device__ __host__ inline size_t k_smem_floats(int H) {
  return (size_t)kKT7 * kLD64 + (size_t)H * kKT7 * kLD64 +
         2 * k_stage_floats(H) + (size_t)2 * H * 16 * kLDT7 +
         (size_t)kKT7 * ld_ds(H) + (size_t)H * kKT7 + 2 * kKT7;
}

template <int kTPW>
__global__ void __launch_bounds__(kMaxThreads, 1)
flash_bwd_k_hf_kernel(Operands op, float* __restrict__ dvw,
                      float* __restrict__ dck, float* __restrict__ dx,
                      float* __restrict__ scratch, int H, int N, int D,
                      int DV, float inv_sqrt) {
  extern __shared__ float smem[];
  const int stage = (int)k_stage_floats(H), ldds = ld_ds(H);
  float* xs = smem;                       // [kKT7][kLD64]     key tile
  float* vws = xs + kKT7 * kLD64;         // [H][kKT7][kLD64]  its values
  float* ring = vws + H * kKT7 * kLD64;   // 2 x {xa [H x 8][kLD64],
                                          //  g [H x 8][kLD64],
                                          //  pe [kQT7][kLDP7], rc [H][6][8]}
  float* ats = ring + 2 * stage;          // [2H warps][16][kLDT7] attn^T
  float* dss = ats + 2 * H * 16 * kLDT7;  // [kKT7][H x 8 (+4)] ds^T
  float* cks = dss + kKT7 * ldds;         // [H][kKT7]
  float* dgs = cks + H * kKT7;            // [kKT7]
  float* kms = dgs + kKT7;                // [kKT7]

  const int nk = (N + kKT7 - 1) / kKT7;
  const int k0 = (blockIdx.x % nk) * kKT7;
  const int b = blockIdx.x / nk, B = gridDim.x / nk;
  const int split = blockIdx.y, splits = gridDim.y;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int warp = tid / 32, g = tc::lane_g(), t = tc::lane_t();
  const int h = warp / 2, kr0 = 16 * (warp % 2);

  const size_t bh = (size_t)b * H + h;
  const float* xa_b = op.xa + (size_t)b * H * N * D;
  const float* g_b = op.g + (size_t)b * H * N * DV;
  const float* pe_b = op.pe ? op.pe + (size_t)b * N * N : nullptr;
  float* const at_w = ats + warp * 16 * kLDT7;

  // 16-byte copies where every row allows them: each thread then stages
  // fixed chunks of rows of 64 floats, chunk i at row i / 16, column
  // 4 (i % 16), zero beyond the width and the ragged edge
  const bool vec_rows = tc::vec_ok(xa_b, D, (size_t)N * D, 0, D) &&
                        tc::vec_ok(g_b, DV, (size_t)N * DV, 0, DV);
  const bool vec_keys =
      N % 4 == 0 && (!pe_b || tc::vec_ok(pe_b, N, 0, k0, kKT7)) &&
      tc::vec_ok(op.cq, 0, 0, 0, 4) && tc::vec_ok(op.m, 0, 0, 0, 4) &&
      tc::vec_ok(op.ise, 0, 0, 0, 4) && tc::vec_ok(op.qa, 0, 0, 0, 4) &&
      tc::vec_ok(op.beta, 0, 0, 0, 4) && tc::vec_ok(op.c, 0, 0, 0, 4);

  auto issue = [&](int q0, int s) {
    float* st = ring + s * stage;
    float* pes = st + 2 * H * kQT7 * kLD64;
    float* rcs = pes + kQT7 * kLDP7;
    if (vec_rows) {
      for (int i = tid; i < H * kQT7 * 16; i += nthreads) {
        const int row = i >> 4, c = (i & 15) * 4;
        const int hh = row >> 3, q = q0 + (row & 7);
        const bool in = q < N;
        tc::cp_async16(st + row * kLD64 + c,
                       xa_b + ((size_t)hh * N + q) * D + c, in && c < D);
        tc::cp_async16(st + (H * kQT7 + row) * kLD64 + c,
                       g_b + ((size_t)hh * N + q) * DV + c, in && c < DV);
      }
    } else {
      tc::stage_rows(st, kLD64, xa_b, D, q0, kQT7, N, 0, D, D, tid,
                     nthreads, H, (size_t)N * D, kQT7 * kLD64);
      tc::stage_rows(st + H * kQT7 * kLD64, kLD64, g_b, DV, q0, kQT7, N, 0,
                     DV, DV, tid, nthreads, H, (size_t)N * DV,
                     kQT7 * kLD64);
    }
    if (vec_keys) {
      if (pe_b && tid < kQT7 * kKT7 / 4) {
        const int r = tid >> 3, c = (tid & 7) * 4;
        const bool in = q0 + r < N && k0 + c < N;
        tc::cp_async16(pes + r * kLDP7 + c,
                       pe_b + (size_t)(q0 + r) * N + k0 + c, in);
      }
      if (tid < H * kNRC * 2) {  // rc[hh][j][8]: two chunks a row
        const int row = tid >> 1, c = (tid & 1) * 4;
        const int hh = row / kNRC, j = row - hh * kNRC;
        const float* v = j == 0 ? op.cq : j == 1 ? op.m : j == 2 ? op.ise
                       : j == 3 ? op.qa : j == 4 ? op.beta : op.c;
        tc::cp_async16(rcs + row * kQT7 + c,
                       v + ((size_t)b * H + hh) * N + q0 + c, q0 + c < N);
      }
    } else {
      if (pe_b)
        tc::stage_rows(pes, kLDP7, pe_b, N, q0, kQT7, N, k0, kKT7, N, tid,
                       nthreads);
      const float* const rows[kNRC] = {op.cq, op.m, op.ise, op.qa, op.beta,
                                       op.c};
      for (int j = 0; j < kNRC; ++j)
        tc::stage_rows(rcs + j * kQT7, kQT7, rows[j] + (size_t)b * H * N, 0,
                       0, 1, 1, q0, kQT7, N, tid, nthreads, H, N,
                       kNRC * kQT7);
    }
    tc::cp_async_commit();
  };

  // this split's query tiles
  const int nqt = (N + kQT7 - 1) / kQT7;
  const int it0 = split * nqt / splits, it1 = (split + 1) * nqt / splits;
  if (it0 < it1) issue(it0 * kQT7, 0);
  tc::stage_rows(xs, kLD64, op.x + (size_t)b * N * D, D, k0, kKT7, N, 0, D,
                 D, tid, nthreads);
  tc::stage_rows(vws, kLD64, op.vw + (size_t)b * H * N * DV, DV, k0, kKT7,
                 N, 0, DV, DV, tid, nthreads, H, (size_t)N * DV,
                 kKT7 * kLD64);
  tc::cp_async_commit();
  for (int i = tid; i < H * kKT7; i += nthreads) {
    const int hh = i / kKT7, key = k0 + i % kKT7;
    cks[i] = key < N ? op.ck[((size_t)b * H + hh) * N + key] : 0.f;
    if (hh == 0) {
      dgs[i] = key < N ? (op.deg ? op.deg[(size_t)b * N + key] : 1.f) : 0.f;
      kms[i] = key < N ? op.mask[(size_t)b * N + key] : 0.f;
    }
  }
  const float c0h = op.c0[h];
  const int D8 = (D + 7) & ~7, DV8 = (DV + 7) & ~7;
  const int x_tiles = 2 * (D8 / 8);       // dx output tiles of 16 x 8
  const float* hvw = vws + h * kKT7 * kLD64;

  // C fragments: dvw rows kr0 + g (+8), columns 8 n + 2 t (+1); dx tile
  // warp + 2H j: keys 16 (tile % 2) + g (+8), columns 8 (tile / 2) + 2 t
  float acc_v[8][4] = {}, acc_x[kTPW][4] = {};
  RunSum colsum[2];

  for (int it = it0; it < it1; ++it) {
    const int q0 = it * kQT7;
    tc::cp_async_wait_all();
    __syncthreads();  // tile `it` visible; every warp done with it - 1
    if (it + 1 < it1) issue(q0 + kQT7, (it + 1 - it0) & 1);
    const float* st = ring + ((it - it0) & 1) * stage;
    const float* xas = st + h * kQT7 * kLD64;
    const float* gs = st + (H + h) * kQT7 * kLD64;
    const float* pes = st + 2 * H * kQT7 * kLD64;
    const float* rcs = pes + kQT7 * kLDP7 + h * kNRC * kQT7;

    // s^T as the forward's FMA chain (graphit_tile.cuh's dot4; the
    // forward's micro_dot) at the thread's C-fragment positions, keys
    // kr0 + g (+8) and queries 2 t (+1); ga^T = vw_h g_h^T on the tensor
    // cores (even and odd k-steps in two accumulators), or as an FMA chain
    // where DV rounds to 8 (flash_bwd.cu's k pass says why)
    float s[4] = {}, ga2[2][4] = {}, tile[2] = {0.f, 0.f};
    const float* krow = xs + (kr0 + g) * kLD64;
    const float* qrow = xas + 2 * t * kLD64;
#pragma unroll
    for (int kk = 0; kk < kMaxW; kk += 8) {
      if (kk < DV8 && DV8 > 8)
        tc::mma3(ga2[(kk / 8) & 1], tc::load_a(hvw, kLD64, kr0, kk),
                 tc::load_b_nk(gs, kLD64, 0, kk));
      if (kk == 0 && DV8 == 8) {   // ga as an FMA chain
        const float* vrow = hvw + (kr0 + g) * kLD64;
        const float* grow = gs + 2 * t * kLD64;
#pragma unroll
        for (int k = 0; k < 8; k += 4) {
          const float4 vv[2] = {ld4(vrow + k), ld4(vrow + 8 * kLD64 + k)};
#pragma unroll
          for (int f = 0; f < 2; ++f) {
            const float4 gq = ld4(grow + f * kLD64 + k);
#pragma unroll
            for (int e = 0; e < 2; ++e)
              ga2[0][2 * e + f] = dot4(gq, vv[e], ga2[0][2 * e + f]);
          }
        }
      }
      if (kk < D8) {
#pragma unroll
        for (int k = kk; k < kk + 8; k += 4) {
          const float4 kv[2] = {ld4(krow + k), ld4(krow + 8 * kLD64 + k)};
#pragma unroll
          for (int f = 0; f < 2; ++f) {
            const float4 qv = ld4(qrow + f * kLD64 + k);
#pragma unroll
            for (int e = 0; e < 2; ++e)
              s[2 * e + f] = dot4(qv, kv[e], s[2 * e + f]);
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int kl = kr0 + g + 8 * (i >> 1), ql = 2 * t + (i & 1);
      float d = 0.f, attn = 0.f;
      if (k0 + kl < N && q0 + ql < N) {
        const float pd = (pe_b ? pes[ql * kLDP7 + kl] : 1.f) * dgs[kl];
        d = grad_score(s[i], rcs[ql], cks[h * kKT7 + kl], c0h, inv_sqrt,
                       kms[kl], rcs[kQT7 + ql], rcs[2 * kQT7 + ql],
                       rcs[3 * kQT7 + ql], rcs[4 * kQT7 + ql],
                       rcs[5 * kQT7 + ql], pd, ga2[0][i] + ga2[1][i], attn);
      }
      tile[i >> 1] += d;
      at_w[(kl - kr0) * kLDT7 + ql] = attn;
      dss[kl * ldds + h * kQT7 + ql] = d;
    }
    colsum[0].add(tile[0], it - it0);
    colsum[1].add(tile[1], it - it0);
    __syncwarp();  // the warp's attn^T complete

    // dvw[key, v] += sum_q attn^T[key, q] g[q, v]: each column tile's sum
    // over the tile's 8 queries is one k-step into a fresh partial, then
    // added to the running sum (flash_fwd.cu's note on summation order)
    const tc::FragA fa = tc::load_a(at_w, kLDT7, 0, 0);
#pragma unroll
    for (int n = 0; n < 8; ++n)
      if (8 * n < DV8) {
        float part[4] = {};
        tc::mma3(part, fa, tc::load_b_kn(gs, kLD64, 0, 8 * n));
#pragma unroll
        for (int i = 0; i < 4; ++i) acc_v[n][i] += part[i];
      }
    __syncthreads();  // every head's ds^T complete

    // dx[key, k] += sum_(h, q) ds^T[key, (h, q)] xa[(h, q), k]: K = the
    // heads in order, 8 queries each; the tile's sum into a fresh partial
#pragma unroll
    for (int j = 0; j < kTPW; ++j) {
      const int tile = warp + 2 * H * j;
      if (tile >= x_tiles) continue;
      float part2[2][4] = {};
#pragma unroll
      for (int hh = 0; hh < kMaxHeads; ++hh)
        if (hh < H)
          tc::mma3(part2[hh & 1], tc::load_a(dss, ldds, 16 * (tile & 1),
                                             kQT7 * hh),
                   tc::load_b_kn(st, kLD64, kQT7 * hh, 8 * (tile >> 1)));
#pragma unroll
      for (int i = 0; i < 4; ++i) acc_x[j][i] += part2[0][i] + part2[1][i];
    }
  }
  tc::cp_async_wait_all();  // the key tile, where the split had no tile

  // outputs: to dvw / dck / dx, or with several splits to this split's
  // partials in `scratch` ([splits][dvw | dck | dx], summed afterwards)
  const size_t n_dvw = (size_t)B * H * N * DV, n_dck = (size_t)B * H * N;
  if (splits > 1) {
    float* base = scratch + (size_t)split * (n_dvw + n_dck + (size_t)B * N * D);
    dvw = base;
    dck = base + n_dvw;
    dx = base + n_dvw + n_dck;
  }
  // dck: each thread's column sums over its queries (tile by tile), then
  // the 4 lanes of its row in a fixed xor order; each warp owns its keys
  // of its head
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    float v = colsum[j].sum();
    v += __shfl_xor_sync(0xffffffffu, v, 1);
    v += __shfl_xor_sync(0xffffffffu, v, 2);
    const int key = k0 + kr0 + g + 8 * j;
    if (t == 0 && key < N) dck[bh * N + key] = v;
  }
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int key = k0 + kr0 + g + 8 * (i >> 1);
      const int col = 8 * n + 2 * t + (i & 1);
      if (col < DV && key < N) dvw[(bh * N + key) * DV + col] = acc_v[n][i];
    }
#pragma unroll
  for (int j = 0; j < kTPW; ++j) {
    const int tile = warp + 2 * H * j;
    if (tile >= x_tiles) continue;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int key = k0 + 16 * (tile & 1) + g + 8 * (i >> 1);
      const int col = 8 * (tile >> 1) + 2 * t + (i & 1);
      if (col < D && key < N)
        dx[((size_t)b * N + key) * D + col] = acc_x[j][i];
    }
  }
}

// out[i] = sum_s parts[s * stride + i] over the splits in order, for the
// three outputs of flash_bwd_k_hf_kernel laid out one after the other
__global__ void sum_splits_kernel(const float* __restrict__ parts,
                                  float* __restrict__ dvw,
                                  float* __restrict__ dck,
                                  float* __restrict__ dx, size_t n_dvw,
                                  size_t n_dck, size_t n_dx, int splits) {
  const size_t stride = n_dvw + n_dck + n_dx;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < stride;
       i += (size_t)gridDim.x * blockDim.x) {
    float total = 0.f;
    for (int s = 0; s < splits; ++s) total += parts[s * stride + i];
    if (i < n_dvw)
      dvw[i] = total;
    else if (i < n_dvw + n_dck)
      dck[i - n_dvw] = total;
    else
      dx[i - n_dvw - n_dck] = total;
  }
}

size_t smem_fwd(int H, int D, int DV) {
  return sizeof(float) *
         ((size_t)H * D * kLD16 + (size_t)D * kLDF + (size_t)H * kFK * DV +
          (size_t)kTile * kLDF + (size_t)H * kTile * kLDF +
          (size_t)H * kFK + kFK);
}

size_t smem_k(int H) { return sizeof(float) * k_smem_floats(H); }

bool bad_shape(int B, int H, int N, int D, int DV) {
  return B <= 0 || H <= 0 || H > kMaxHeads || N <= 0 || D <= 0 ||
         D > kMaxW || DV <= 0 || DV > kMaxW;
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
  return bwdq::launch<true>(
      operands(xa, x, cq, ck, c0, vw, pe, deg, mask, g, m, ise, qa, beta, c),
      (float*)dxa, (float*)dcq, B, H, N, D, DV, inv_sqrt,
      (cudaStream_t)stream);
}

// With splits > 1 the query loop is split over that many blocks per key
// tile; `scratch` holds splits x (B*H*N*DV + B*H*N + B*N*D) floats of
// partials, summed in split order by a second launch (unused at 1).
extern "C" int feta_flash_bwd_k_hf(const void* xa, const void* x,
                                   const void* cq, const void* ck,
                                   const void* c0, const void* vw,
                                   const void* pe, const void* deg,
                                   const void* mask, const void* g,
                                   const void* m, const void* ise,
                                   const void* qa, const void* beta,
                                   const void* c, void* dvw, void* dck,
                                   void* dx, void* scratch, int B, int H,
                                   int N, int D, int DV, int splits,
                                   float inv_sqrt, void* stream) {
  if (bad_shape(B, H, N, D, DV) || splits < 1 || splits > kMaxSplits ||
      (splits > 1 && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  // dx output tiles (2 x D8 / 8) over the 2H warps: kTPW a warp
  const int tiles = 2 * ((D + 7) / 8), per = (tiles + 2 * H - 1) / (2 * H);
  auto kernel = per <= 1   ? flash_bwd_k_hf_kernel<1>
                : per <= 2 ? flash_bwd_k_hf_kernel<2>
                : per <= 4 ? flash_bwd_k_hf_kernel<4>
                           : flash_bwd_k_hf_kernel<8>;
  const size_t smem = smem_k(H);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int nk = (N + kKT7 - 1) / kKT7;
  kernel<<<dim3(B * nk, splits), kGroup * H, smem, (cudaStream_t)stream>>>(
      operands(xa, x, cq, ck, c0, vw, pe, deg, mask, g, m, ise, qa, beta, c),
      (float*)dvw, (float*)dck, (float*)dx, (float*)scratch, H, N, D, DV,
      inv_sqrt);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  const size_t n_dvw = (size_t)B * H * N * DV, n_dck = (size_t)B * H * N;
  const size_t n_dx = (size_t)B * N * D, total = n_dvw + n_dck + n_dx;
  const int blocks = (int)((total + 255) / 256);
  sum_splits_kernel<<<blocks < 4096 ? blocks : 4096, 256, 0,
                      (cudaStream_t)stream>>>(
      (const float*)scratch, (float*)dvw, (float*)dck, (float*)dx, n_dvw,
      n_dck, n_dx, splits);
  return (int)cudaGetLastError();
}

extern "C" const char* feta_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
