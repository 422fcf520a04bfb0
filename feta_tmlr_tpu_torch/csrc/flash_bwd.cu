// Backward of the online-softmax GraphiT attention, f32, for sm_90a.
//
// Replaces the two TPU kernels of feta_tmlr_tpu/ops/pallas/flash_attention.py
// launched by `_call_bwd`: `_bwd_q_kernel` (dxa, dcq) and `_bwd_k_kernel`
// (dvw, dck, dx). Both recompute the attention tiles of one (graph b,
// head h) from the forward's row statistics, as the JAX package's
// `_recompute_block` does:
//
//   s[i,j]  = (xa_h[i]·x[j] + cq[i] + ck[j] + c0) * inv_sqrt,
//             -1e30 where key j is padding (graphit_tile.cuh)
//   a[i,j]  = exp(s[i,j] - m[i]) * ise[i]
//   pd[i,j] = pe[i,j] * deg[j]                (either may be absent: 1)
//   attn    = a * pd * qa[i] * kmask[j]
//   ga[i,j] = g_h[i]·vw_h[j]                  (g: the per-head cotangent)
//   du      = ga * kmask[j] * qa[i] - beta[i]
//   ds      = a * (du * pd - c[i]) * inv_sqrt
//
// with the row constants ise = 1/se, qa = qmask/safe, beta, c computed
// outside from (m, se, su) and the cotangent (common.py,
// `bwd_row_constants`). Then
//
//   flash_bwd_q_kernel:  dxa_h = ds @ x,        dcq_h = sum_j ds
//   flash_bwd_k_kernel:  dvw_h = attn^T @ g_h,  dck_h = sum_i ds,
//                        dx    = sum_h ds^T @ xa_h
//
// What bounds them on the H100: arithmetic. Per (b, h) the q pass does
// 2·N²·(2D + DV) FMA-flops and the k pass 2·N²·(2D + 2DV), on CUDA cores in
// full f32 (no TF32), against 67 TFLOP/s; the bytes they must move are a
// few percent of what the card streams in that time. The design is the
// forward's (flash_fwd.cu): 64x64 tiles, 256 threads, each thread owning
// 4x4 register micro-tiles, operands staged transposed in shared memory
// with a padded stride. The tile products run as one k-loop of FMAs each.
//
// No carry between blocks. The TPU's `_bwd_k_kernel` sums dx over heads in
// scratch because h is its innermost sequential grid axis. GPU blocks run
// in no order, so the k pass writes one dx partial per head, [B, H, N, D],
// and a second launch (head_sum_kernel, same source, same wrapper) adds the
// H partials in a fixed order. A block that looped over the heads itself
// would leave only B·N/64 blocks (128 at B=8, N=1024), under one wave on
// 132 SMs; the partials cost 2 x 16 MiB of traffic at that shape, about
// 10 microseconds. No float atomics anywhere: every gradient is
// bit-identical from run to run.
//
// Grids: one block per (b, query tile, h) for the q pass and per (b, key
// tile, h) for the k pass, h fastest, so the H blocks that read the same
// pe tile run together and find it in L2. Each block loops over the other
// axis itself, so dcq and dck are complete inside one block (the column
// sums reduce over the 16 thread rows in a fixed order). Ragged N: rows and
// keys >= N contribute exactly 0 and are not stored; padded queries inside
// N have qa = 0 and r = 0, so ds = 0 there without a special case.
//
// C interface (ctypes): pointers and the stream as void*, returns the
// cudaError_t of the launch.

#include <cuda_runtime.h>
#include <math.h>

#include "graphit_tile.cuh"

namespace {

using namespace graphit;

constexpr int kMaxW = 64;           // D and DV at most 64
constexpr int kOut = kMaxW / kTX;   // output columns per thread

__device__ __forceinline__ void stage_keys(float* ps, float* cks, float* dgs,
                                           float* kms, const float* pe_b,
                                           const float* ck_bh,
                                           const float* deg_b,
                                           const float* mask_b, int q0,
                                           int k0, int N, int tid,
                                           bool stage_key_vectors) {
  for (int i = tid; i < kBQ * kBK; i += kThreads) {
    const int r = i / kBK, c = i % kBK, q = q0 + r, key = k0 + c;
    float p = 0.f;
    if (q < N && key < N) p = pe_b ? pe_b[(size_t)q * N + key] : 1.f;
    ps[r * kLDK + c] = p;
  }
  if (stage_key_vectors && tid < kBK) {
    const int key = k0 + tid;
    const bool in = key < N;
    cks[tid] = in ? ck_bh[key] : 0.f;
    dgs[tid] = in ? (deg_b ? deg_b[key] : 1.f) : 0.f;
    kms[tid] = in ? mask_b[key] : 0.f;
  }
}

struct Operands {
  const float *xa, *x, *cq, *ck, *c0, *vw, *pe, *deg, *mask, *g;
  const float *m, *ise, *qa, *beta, *c;
};

// At most 128 registers, so that two 256-thread blocks share an SM (84 KB
// of shared memory each). Left free, ptxas takes 151 and fits only one
// block, which ran slower on the H100 than this cap with its 12-byte spill
// (PERF.md).
__global__ void __launch_bounds__(kThreads, 2)
flash_bwd_q_kernel(Operands op, float* __restrict__ dxa,
                   float* __restrict__ dcq, int H, int N, int D, int DV,
                   float inv_sqrt) {
  extern __shared__ float smem[];
  float* xaT = smem;                    // [D][kLDQ]   query tile
  float* gT = xaT + D * kLDQ;           // [DV][kLDQ]  its cotangent
  float* xT = gT + DV * kLDQ;           // [D][kLDK]   key tile
  float* vwT = xT + D * kLDK;           // [DV][kLDK]  its values
  float* ps = vwT + DV * kLDK;          // [kBQ][kLDK] pe tile, then ds
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
  const float* x_b = op.x + (size_t)b * N * D;
  const float* vw_bh = op.vw + bh * N * DV;
  const float* pe_b = op.pe ? op.pe + (size_t)b * N * N : nullptr;
  const float* deg_b = op.deg ? op.deg + (size_t)b * N : nullptr;
  const float* mask_b = op.mask + (size_t)b * N;
  const float* ck_bh = op.ck + bh * N;

  stage_transposed(xaT, kLDQ, op.xa + bh * N * D, q0, N, D, tid);
  stage_transposed(gT, kLDQ, op.g + bh * N * DV, q0, N, DV, tid);
  float cq_r[kRows], m_r[kRows], ise_r[kRows], qa_r[kRows], beta_r[kRows],
      c_r[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int q = q0 + ty + kTY * i;
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

  for (int k0 = 0; k0 < N; k0 += kBK) {
    __syncthreads();  // the previous tile's readers are done
    stage_transposed(xT, kLDK, x_b, k0, N, D, tid);
    stage_transposed(vwT, kLDK, vw_bh, k0, N, DV, tid);
    stage_keys(ps, cks, dgs, kms, pe_b, ck_bh, deg_b, mask_b, q0, k0, N,
               tid, true);
    __syncthreads();

    float s[kRows][kCols], ga[kRows][kCols];
    tile_dot(xaT, xT, D, tx, ty, s);
    tile_dot(gT, vwT, DV, tx, ty, ga);
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = ty + kTY * i;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int c = tx + kTX * j;
        float d = 0.f, attn = 0.f;
        if (q0 + r < N && k0 + c < N)
          d = grad_score(s[i][j], cq_r[i], cks[c], c0h, inv_sqrt, kms[c],
                         m_r[i], ise_r[i], qa_r[i], beta_r[i], c_r[i],
                         ps[r * kLDK + c] * dgs[c], ga[i][j], attn);
        dsum[i] += d;
        ps[r * kLDK + c] = d;  // only this thread touches (r, c)
      }
    }
    __syncthreads();  // ds complete

    // dxa[r, k] += sum_c ds[r, c] * x[c, k]; x read from its transposed
    // tile; the tile's sum into a fresh partial (flash_fwd.cu's note)
    float part[kRows][kOut] = {};
    for (int c = 0; c < kBK; ++c) {
      float p[kRows], xv[kOut];
#pragma unroll
      for (int i = 0; i < kRows; ++i) p[i] = ps[(ty + kTY * i) * kLDK + c];
#pragma unroll
      for (int j = 0; j < kOut; ++j) {
        const int k = tx + kTX * j;
        xv[j] = k < D ? xT[k * kLDK + c] : 0.f;
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
    // the 16 threads sharing row r are 16 consecutive lanes of a warp
#pragma unroll
    for (int off = kTX / 2; off > 0; off >>= 1)
      dsum[i] += __shfl_xor_sync(0xffffffffu, dsum[i], off);
    const int q = q0 + ty + kTY * i;
    if (q >= N) continue;
    const size_t row = bh * N + q;
#pragma unroll
    for (int j = 0; j < kOut; ++j) {
      const int k = tx + kTX * j;
      if (k < D) dxa[row * D + k] = acc[i][j];
    }
    if (tx == 0) dcq[row] = dsum[i];
  }
}

__global__ void __launch_bounds__(kThreads)
flash_bwd_k_kernel(Operands op, float* __restrict__ dvw,
                   float* __restrict__ dck, float* __restrict__ dx_heads,
                   int H, int N, int D, int DV, float inv_sqrt) {
  extern __shared__ float smem[];
  float* xT = smem;                     // [D][kLDK]   key tile (resident)
  float* vwT = xT + D * kLDK;           // [DV][kLDK]  its values (resident)
  float* xaT = vwT + DV * kLDK;         // [D][kLDQ]   query tile
  float* gT = xaT + D * kLDQ;           // [DV][kLDQ]  its cotangent
  float* ps = gT + DV * kLDQ;           // [kBQ][kLDK] pe tile, then attn
  float* dss = ps + kBQ * kLDK;         // [kBQ][kLDK] ds; column reduction
  float* cks = dss + kBQ * kLDK;        // [kBK]
  float* dgs = cks + kBK;               // [kBK]
  float* kms = dgs + kBK;               // [kBK]
  float* cqs = kms + kBK;               // [kBQ] row constants of the tile
  float* ms = cqs + kBQ;
  float* ises = ms + kBQ;
  float* qas = ises + kBQ;
  float* betas = qas + kBQ;
  float* cs = betas + kBQ;

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
  const float* xa_bh = op.xa + bh * N * D;
  const float* g_bh = op.g + bh * N * DV;
  const float* pe_b = op.pe ? op.pe + (size_t)b * N * N : nullptr;
  const float* deg_b = op.deg ? op.deg + (size_t)b * N : nullptr;
  const float* mask_b = op.mask + (size_t)b * N;

  stage_transposed(xT, kLDK, op.x + (size_t)b * N * D, k0, N, D, tid);
  stage_transposed(vwT, kLDK, op.vw + bh * N * DV, k0, N, DV, tid);
  const float c0h = op.c0[h];

  // key-major accumulators: keys ty + 16 i, columns tx + 16 j
  float acc_v[kRows][kOut], acc_x[kRows][kOut], colsum[kCols];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int j = 0; j < kOut; ++j) acc_v[i][j] = acc_x[i][j] = 0.f;
#pragma unroll
  for (int j = 0; j < kCols; ++j) colsum[j] = 0.f;

  for (int q0 = 0; q0 < N; q0 += kBQ) {
    __syncthreads();
    stage_transposed(xaT, kLDQ, xa_bh, q0, N, D, tid);
    stage_transposed(gT, kLDQ, g_bh, q0, N, DV, tid);
    stage_keys(ps, cks, dgs, kms, pe_b, op.ck + bh * N, deg_b, mask_b, q0,
               k0, N, tid, q0 == 0);
    if (tid < kBQ) {
      const int q = q0 + tid;
      const bool in = q < N;
      const size_t row = bh * N + q;
      cqs[tid] = in ? op.cq[row] : 0.f;
      ms[tid] = in ? op.m[row] : 0.f;
      ises[tid] = in ? op.ise[row] : 0.f;
      qas[tid] = in ? op.qa[row] : 0.f;
      betas[tid] = in ? op.beta[row] : 0.f;
      cs[tid] = in ? op.c[row] : 0.f;
    }
    __syncthreads();

    float s[kRows][kCols], ga[kRows][kCols];
    tile_dot(xaT, xT, D, tx, ty, s);
    tile_dot(gT, vwT, DV, tx, ty, ga);
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = ty + kTY * i;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int c = tx + kTX * j;
        float d = 0.f, attn = 0.f;
        if (q0 + r < N && k0 + c < N)
          d = grad_score(s[i][j], cqs[r], cks[c], c0h, inv_sqrt, kms[c],
                         ms[r], ises[r], qas[r], betas[r], cs[r],
                         ps[r * kLDK + c] * dgs[c], ga[i][j], attn);
        colsum[j] += d;
        ps[r * kLDK + c] = attn;  // only this thread touches (r, c)
        dss[r * kLDK + c] = d;
      }
    }
    __syncthreads();  // attn and ds complete

    // dvw[c, v] += sum_r attn[r, c] g[r, v];  dx_h[c, k] += sum_r ds[r, c] xa[r, k]
    add_tile_product<kBQ>(acc_v, ps, kLDK, gT, kLDQ, DV, tx, ty, kTX, kTY);
    add_tile_product<kBQ>(acc_x, dss, kLDK, xaT, kLDQ, D, tx, ty, kTX, kTY);
  }

  // fixed-order reduction of the 16 per-thread partial column sums
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kCols; ++j) dss[ty * kBK + tx + kTX * j] = colsum[j];
  __syncthreads();
  if (tid < kBK && k0 + tid < N) {
    float total = 0.f;
    for (int t = 0; t < kTY; ++t) total += dss[t * kBK + tid];
    dck[bh * N + k0 + tid] = total;
  }
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int key = k0 + ty + kTY * i;
    if (key >= N) continue;
    const size_t row = bh * N + key;
#pragma unroll
    for (int j = 0; j < kOut; ++j) {
      const int col = tx + kTX * j;
      if (col < DV) dvw[row * DV + col] = acc_v[i][j];
      if (col < D) dx_heads[row * D + col] = acc_x[i][j];
    }
  }
}

// dx[b, n, k] = sum_h dx_heads[b, h, n, k], heads added in order 0..H-1.
__global__ void head_sum_kernel(const float* __restrict__ dx_heads,
                                float* __restrict__ dx, int B, int H,
                                size_t ND) {
  const size_t total = (size_t)B * ND;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    const size_t b = i / ND, rest = i % ND;
    const float* src = dx_heads + b * H * ND + rest;
    float t = 0.f;
    for (int h = 0; h < H; ++h) t += src[h * ND];
    dx[i] = t;
  }
}

size_t smem_q(int D, int DV) {
  return sizeof(float) * ((size_t)(D + DV) * (kLDQ + kLDK) +
                          (size_t)kBQ * kLDK + 3 * kBK);
}

size_t smem_k(int D, int DV) {
  return sizeof(float) * ((size_t)(D + DV) * (kLDQ + kLDK) +
                          2 * (size_t)kBQ * kLDK + 3 * kBK + 6 * kBQ);
}

bool bad_shape(int B, int H, int N, int D, int DV) {
  return B <= 0 || H <= 0 || N <= 0 || D <= 0 || D > kMaxW || DV <= 0 ||
         DV > kMaxW;
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

extern "C" int feta_flash_bwd_q(const void* xa, const void* x, const void* cq,
                                const void* ck, const void* c0,
                                const void* vw, const void* pe,
                                const void* deg, const void* mask,
                                const void* g, const void* m, const void* ise,
                                const void* qa, const void* beta,
                                const void* c, void* dxa, void* dcq, int B,
                                int H, int N, int D, int DV, float inv_sqrt,
                                void* stream) {
  if (bad_shape(B, H, N, D, DV)) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_q(D, DV);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_q_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int nq = (N + kBQ - 1) / kBQ;
  flash_bwd_q_kernel<<<B * H * nq, kThreads, smem, (cudaStream_t)stream>>>(
      operands(xa, x, cq, ck, c0, vw, pe, deg, mask, g, m, ise, qa, beta, c),
      (float*)dxa, (float*)dcq, H, N, D, DV, inv_sqrt);
  return (int)cudaGetLastError();
}

// dx_heads is scratch of B*H*N*D floats that the caller allocates.
extern "C" int feta_flash_bwd_k(const void* xa, const void* x, const void* cq,
                                const void* ck, const void* c0,
                                const void* vw, const void* pe,
                                const void* deg, const void* mask,
                                const void* g, const void* m, const void* ise,
                                const void* qa, const void* beta,
                                const void* c, void* dvw, void* dck,
                                void* dx_heads, void* dx, int B, int H, int N,
                                int D, int DV, float inv_sqrt, void* stream) {
  if (bad_shape(B, H, N, D, DV)) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_k(D, DV);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_k_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int nk = (N + kBK - 1) / kBK;
  flash_bwd_k_kernel<<<B * H * nk, kThreads, smem, (cudaStream_t)stream>>>(
      operands(xa, x, cq, ck, c0, vw, pe, deg, mask, g, m, ise, qa, beta, c),
      (float*)dvw, (float*)dck, (float*)dx_heads, H, N, D, DV, inv_sqrt);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t nd = (size_t)N * D;
  const size_t total = (size_t)B * nd;
  const int blocks = (int)((total + kThreads - 1) / kThreads);
  head_sum_kernel<<<blocks < 4096 ? blocks : 4096, kThreads, 0,
                    (cudaStream_t)stream>>>((const float*)dx_heads,
                                            (float*)dx, B, H, nd);
  return (int)cudaGetLastError();
}

extern "C" const char* feta_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
