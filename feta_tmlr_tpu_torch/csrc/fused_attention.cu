// Single-block fused GraphiT attention for small graphs, forward and
// backward, f32, for sm_90a.
//
// Replaces the TPU kernels feta_tmlr_tpu/ops/pallas/fused_attention.py
// `_fwd_kernel` (launched by `_call_fwd`) and `_bwd_kernel` (`_call_bwd`).
// For graph b and head h, over keys j < N:
//
//   s[i,j]  = (xa_h[i]·x[j] + cq[i] + ck[j] + c0) * inv_sqrt,
//             -1e30 where key j is padding
//   a       = softmax_j(s)      u = a * pe[i,j] * deg[j]   (absent: 1)
//   safe[i] = |sum_j u| > 1e-9 ? sum_j u : 1
//   attn    = u / safe * qmask[i] * kmask[j]
//   out[b]  = sum_h attn_h @ vw_h                              [N, D]
//
// and the backward of out: dxa, dx, dcq, dck, dc0 (per graph and head; the
// wrapper sums it over graphs) and dvw, with the guard branch of
// modulation.cu (du = g where |denom| <= 1e-9).
//
// It computes the same function as the online-softmax kernels
// (flash_fwd.cu, flash_bwd.cu) but is built for small N: the whole key row
// of a query lies in shared memory, so the softmax is exact in one pass with
// no running rescaling, and the sums across heads and across query rows are
// taken inside one block instead of by a second launch:
//
//   forward: one block per (b, 32-query tile). It stages x[b] and the tile's
//     pe * deg once and loops over the H heads, keeping the head sum of
//     attn_h @ vw_h in registers. The TPU carried that sum in VMEM scratch
//     across a sequential grid axis; CUDA blocks run in no order, so the
//     loop over heads moves inside the block.
//   backward: one block per graph b, holding the whole [N, N] score and
//     gradient tiles of one head at a time. The column sums over query rows
//     (dvw, dck, and dx, which also sums over heads in registers) are then
//     taken in the block that owns every row, in a fixed order: no atomics,
//     so gradients are bit-identical from run to run.
//
// Limits: D <= 64 (the register tiles) and the backward's shared memory,
// 4 (2 N (D+1) + N D + 2 N^2 + 3 N) bytes <= 227 KB, which holds N <= 128 at
// D = 64. The wrapper raises above N = 128; the C functions refuse any
// shape whose shared memory does not fit.
//
// What bounds it on the H100: operations. The forward does 2 products of
// 2·N²·D FMA-flops per (b, h), the backward 5, in full f32 on CUDA cores
// (67 TFLOP/s), while x, xa, vw, pe and g are read once each: at N = 48,
// D = 64 the work is ~24 operations per byte moved, above the card's ~20.
// The products run from shared memory with 16x16 threads,
// each owning a register micro-tile (4x4, or 2x4 for the forward's
// 32-query tile), so each shared-memory read feeds 2-4 FMAs. Operands read
// along a row of a transposed product are staged with an odd stride (D+1),
// which keeps a warp's 16 column reads on 16 banks.
//
// C interface (ctypes): pointers and the stream as void*, returns the
// cudaError_t of the launch.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kTX = 16;
constexpr int kTY = 16;
constexpr int kThreads = kTX * kTY;
constexpr int kWarps = kThreads / 32;
constexpr int kTQ = 32;              // forward query rows per block
constexpr int kMaxD = 64;            // register tiles cover 4 x 16 columns
constexpr size_t kMaxSmem = 232448;  // 227 KB, the H100's per-block limit
constexpr float kMaskedScore = -1e30f;
constexpr float kEps = 1e-9f;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// acc[i][j] += sum_k A(r, k) B(k, c) for the thread's rows
// r = r0 + ty + 16 i (i < RM) and columns c = c0 + tx + 16 j (j < RC), with
// A(r, k) = A[r * sar + k * sak] and B(k, c) = B[k * sbk + c * sbc]; rows
// >= M and columns >= C contribute nothing.
template <int RM, int RC>
__device__ __forceinline__ void tile_product(
    const float* A, int sar, int sak, const float* B, int sbk, int sbc,
    int r0, int c0, int M, int C, int K, float (&acc)[RM][RC]) {
  const int tx = threadIdx.x % kTX, ty = threadIdx.x / kTX;
  bool row_in[RM], col_in[RC];
#pragma unroll
  for (int i = 0; i < RM; ++i) row_in[i] = r0 + ty + kTY * i < M;
#pragma unroll
  for (int j = 0; j < RC; ++j) col_in[j] = c0 + tx + kTX * j < C;
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float a[RM], b[RC];
#pragma unroll
    for (int i = 0; i < RM; ++i)
      a[i] = row_in[i] ? A[(r0 + ty + kTY * i) * sar + k * sak] : 0.f;
#pragma unroll
    for (int j = 0; j < RC; ++j)
      b[j] = col_in[j] ? B[k * sbk + (c0 + tx + kTX * j) * sbc] : 0.f;
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < RC; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

template <int RM, int RC>
__device__ __forceinline__ void zero(float (&acc)[RM][RC]) {
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < RC; ++j) acc[i][j] = 0.f;
}

// dst[r * ld + c] = src[r * cols + c] for r < rows, c < cols.
__device__ __forceinline__ void stage(float* dst, int ld, const float* src,
                                      int rows, int cols) {
  for (int idx = threadIdx.x; idx < rows * cols; idx += kThreads)
    dst[(idx / cols) * ld + idx % cols] = src[idx];
}

// Scores of rows [r0, r0 + 64) x keys [c0, c0 + 64) (RM = 4) or of a
// 32-row tile (RM = 2) into ps[r * N + c]: xa rows in hs (stride ldx), keys
// in xs (stride ldx), cq of the rows at cq_rows, ck of the keys in cks.
template <int RM>
__device__ __forceinline__ void scores_tile(
    const float* hs, const float* xs, int ldx, const float* cq_rows,
    const float* cks, const float* kms, float c0h, float inv_sqrt, int r0,
    int c0, int M, int N, int D, float* ps) {
  const int tx = threadIdx.x % kTX, ty = threadIdx.x / kTX;
  float s[RM][4];
  zero(s);
  tile_product<RM, 4>(hs, ldx, 1, xs, 1, ldx, r0, c0, M, N, D, s);
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int r = r0 + ty + kTY * i;
    if (r >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = c0 + tx + kTX * j;
      if (c >= N) continue;
      ps[r * N + c] = kms[c] > 0.f
                          ? (s[i][j] + cq_rows[r] + cks[c] + c0h) * inv_sqrt
                          : kMaskedScore;
    }
  }
}

// Softmax numerators of one score row held in shared memory, by one warp:
// s[j] <- exp(s[j] - max_j s) in place, and their sum se.
__device__ __forceinline__ void row_exp(float* s, int N, int lane, float* se) {
  float mx = -INFINITY;
  for (int j = lane; j < N; j += 32) mx = fmaxf(mx, s[j]);
  mx = warp_max(mx);
  float sum = 0.f;
  for (int j = lane; j < N; j += 32) {
    const float e = expf(s[j] - mx);
    s[j] = e;
    sum += e;
  }
  *se = warp_sum(sum);
}

__global__ void __launch_bounds__(kThreads)
fused_fwd_kernel(const float* __restrict__ xa, const float* __restrict__ x,
                 const float* __restrict__ cq, const float* __restrict__ ck,
                 const float* __restrict__ c0, const float* __restrict__ vw,
                 const float* __restrict__ pe, const float* __restrict__ deg,
                 const float* __restrict__ mask, float* __restrict__ out,
                 int H, int N, int D, float inv_sqrt) {
  extern __shared__ float smem[];
  const int ldx = D + 1;
  float* xs = smem;              // [N][ldx]   keys x[b]
  float* hs = xs + N * ldx;      // [kTQ][ldx] xa_h of the tile's rows
  float* vs = hs + kTQ * ldx;    // [N][D]     vw_h
  float* ps = vs + N * D;        // [kTQ][N]   scores, then attention
  float* pds = ps + kTQ * N;     // [kTQ][N]   pe * deg of the tile's rows
  float* kms = pds + kTQ * N;    // [N]        key mask
  float* cks = kms + N;          // [N]        ck_h
  float* cqs = cks + N;          // [kTQ]      cq_h of the tile's rows

  const int nq = (N + kTQ - 1) / kTQ;
  const int q0 = (blockIdx.x % nq) * kTQ;
  const int b = blockIdx.x / nq;
  const int rows = min(kTQ, N - q0);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const float* mask_b = mask + (size_t)b * N;

  stage(xs, ldx, x + (size_t)b * N * D, N, D);
  for (int j = tid; j < N; j += kThreads) kms[j] = mask_b[j];
  for (int idx = tid; idx < rows * N; idx += kThreads) {
    const int r = idx / N, j = idx % N;
    const float p = pe ? pe[((size_t)b * N + q0 + r) * N + j] : 1.f;
    pds[idx] = p * (deg ? deg[(size_t)b * N + j] : 1.f);
  }

  float acc[2][4];
  zero(acc);
  for (int h = 0; h < H; ++h) {
    const size_t bh = (size_t)b * H + h;
    __syncthreads();  // the previous head's readers are done
    stage(hs, ldx, xa + (bh * N + q0) * D, rows, D);
    stage(vs, D, vw + bh * N * D, N, D);
    for (int j = tid; j < N; j += kThreads) cks[j] = ck[bh * N + j];
    for (int r = tid; r < rows; r += kThreads) cqs[r] = cq[bh * N + q0 + r];
    __syncthreads();
    for (int k0 = 0; k0 < N; k0 += 4 * kTX)
      scores_tile<2>(hs, xs, ldx, cqs, cks, kms, c0[h], inv_sqrt, 0, k0, rows,
                     N, D, ps);
    __syncthreads();
    for (int r = warp; r < rows; r += kWarps) {
      float* s = ps + r * N;
      const float* pd = pds + r * N;
      float se;
      row_exp(s, N, lane, &se);
      float den = 0.f;
      for (int j = lane; j < N; j += 32) den += s[j] / se * pd[j];
      den = warp_sum(den);
      const float safe = fabsf(den) > kEps ? den : 1.f;
      const float qm = mask_b[q0 + r];
      for (int j = lane; j < N; j += 32)
        s[j] = s[j] / se * pd[j] / safe * qm * kms[j];
    }
    __syncthreads();
    tile_product<2, 4>(ps, N, 1, vs, D, 1, 0, 0, rows, D, N, acc);
  }

  const int tx = tid % kTX, ty = tid / kTX;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = ty + kTY * i;
    if (r >= rows) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx + kTX * j;
      if (c < D) out[((size_t)b * N + q0 + r) * D + c] = acc[i][j];
    }
  }
}

__global__ void __launch_bounds__(kThreads)
fused_bwd_kernel(const float* __restrict__ xa, const float* __restrict__ x,
                 const float* __restrict__ cq, const float* __restrict__ ck,
                 const float* __restrict__ c0, const float* __restrict__ vw,
                 const float* __restrict__ pe, const float* __restrict__ deg,
                 const float* __restrict__ mask, const float* __restrict__ g,
                 float* __restrict__ dxa, float* __restrict__ dx,
                 float* __restrict__ dcq, float* __restrict__ dck,
                 float* __restrict__ dc0, float* __restrict__ dvw, int H,
                 int N, int D, float inv_sqrt) {
  extern __shared__ float smem[];
  const int ldx = D + 1;
  float* xs = smem;              // [N][ldx] keys x[b]
  float* hs = xs + N * ldx;      // [N][ldx] vw_h, then xa_h
  float* gs = hs + N * ldx;      // [N][D]   g[b]
  float* ps = gs + N * D;        // [N][N]   scores, then attention
  float* qs = ps + N * N;        // [N][N]   d attn, then ds
  float* kms = qs + N * N;       // [N]      key mask
  float* dgs = kms + N;          // [N]      degree (1 where absent)
  float* red = dgs + N;          // [N]      ck_h, then dck_h

  const int b = blockIdx.x;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int tx = tid % kTX, ty = tid / kTX;
  const float* mask_b = mask + (size_t)b * N;
  const float* pe_b = pe ? pe + (size_t)b * N * N : nullptr;

  stage(xs, ldx, x + (size_t)b * N * D, N, D);
  stage(gs, D, g + (size_t)b * N * D, N, D);
  for (int j = tid; j < N; j += kThreads) {
    kms[j] = mask_b[j];
    dgs[j] = deg ? deg[(size_t)b * N + j] : 1.f;
  }

  float dx_acc[8][4];  // rows ty + 16 i (N <= 128), columns tx + 16 j
  zero(dx_acc);
  for (int h = 0; h < H; ++h) {
    const size_t bh = (size_t)b * H + h;
    __syncthreads();  // the previous head's readers of hs and red are done
    stage(hs, ldx, vw + bh * N * D, N, D);
    for (int j = tid; j < N; j += kThreads) red[j] = ck[bh * N + j];
    __syncthreads();
    // d attn = g vw_h^T
    for (int r0 = 0; r0 < N; r0 += 4 * kTY)
      for (int k0 = 0; k0 < N; k0 += 4 * kTX) {
        float t[4][4];
        zero(t);
        tile_product<4, 4>(gs, D, 1, hs, 1, ldx, r0, k0, N, N, D, t);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int r = r0 + ty + kTY * i, c = k0 + tx + kTX * j;
            if (r < N && c < N) qs[r * N + c] = t[i][j];
          }
      }
    __syncthreads();
    stage(hs, ldx, xa + bh * N * D, N, D);
    __syncthreads();
    for (int r0 = 0; r0 < N; r0 += 4 * kTY)
      for (int k0 = 0; k0 < N; k0 += 4 * kTX)
        scores_tile<4>(hs, xs, ldx, cq + bh * N, red, kms, c0[h], inv_sqrt,
                       r0, k0, N, N, D, ps);
    __syncthreads();
    // the chain and its backward, one warp per query row: ps <- attn,
    // qs <- ds * inv_sqrt, dcq
    for (int r = warp; r < N; r += kWarps) {
      float* s = ps + r * N;
      float* q = qs + r * N;
      const float* pe_r = pe_b ? pe_b + (size_t)r * N : nullptr;
      const float qm = mask_b[r];
      float se;
      row_exp(s, N, lane, &se);
      float den = 0.f, rs = 0.f;
      for (int j = lane; j < N; j += 32) {
        const float u = s[j] / se * ((pe_r ? pe_r[j] : 1.f) * dgs[j]);
        den += u;
        rs += q[j] * qm * kms[j] * u;
      }
      den = warp_sum(den);
      rs = warp_sum(rs);
      const bool on = fabsf(den) > kEps;
      const float safe = on ? den : 1.f;
      const float beta = (rs / (safe * safe)) * (on ? 1.f : 0.f);
      float t = 0.f;
      for (int j = lane; j < N; j += 32) {
        const float a = s[j] / se;
        const float p = (pe_r ? pe_r[j] : 1.f) * dgs[j];
        t += (q[j] * qm * kms[j] / safe - beta) * p * a;
      }
      t = warp_sum(t);
      float rowsum = 0.f;
      for (int j = lane; j < N; j += 32) {
        const float a = s[j] / se;
        const float p = (pe_r ? pe_r[j] : 1.f) * dgs[j];
        const float da = (q[j] * qm * kms[j] / safe - beta) * p;
        const float ds = a * (da - t) * inv_sqrt;
        s[j] = a * p / safe * qm * kms[j];
        q[j] = ds;
        rowsum += ds;
      }
      rowsum = warp_sum(rowsum);
      if (lane == 0) dcq[bh * N + r] = rowsum;
    }
    __syncthreads();
    // dck: column sums of ds over every query row, in row order
    for (int j = tid; j < N; j += kThreads) {
      float sum = 0.f;
      for (int i = 0; i < N; ++i) sum += qs[i * N + j];
      red[j] = sum;
      dck[bh * N + j] = sum;
    }
    // dvw_h = attn^T g and dxa_h = ds x
    for (int r0 = 0; r0 < N; r0 += 4 * kTY) {
      float t[4][4];
      zero(t);
      tile_product<4, 4>(ps, 1, N, gs, D, 1, r0, 0, N, D, N, t);
      float u[4][4];
      zero(u);
      tile_product<4, 4>(qs, N, 1, xs, ldx, 1, r0, 0, N, D, N, u);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = r0 + ty + kTY * i, c = tx + kTX * j;
          if (r < N && c < D) {
            dvw[(bh * N + r) * D + c] = t[i][j];
            dxa[(bh * N + r) * D + c] = u[i][j];
          }
        }
    }
    // dx += ds^T xa_h, summed over the heads in registers
    tile_product<8, 4>(qs, 1, N, hs, ldx, 1, 0, 0, N, D, N, dx_acc);
    __syncthreads();  // red holds every dck
    if (warp == 0) {
      float sum = 0.f;
      for (int j = lane; j < N; j += 32) sum += red[j];
      sum = warp_sum(sum);
      if (lane == 0) dc0[bh] = sum;
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = ty + kTY * i;
    if (r >= N) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx + kTX * j;
      if (c < D) dx[((size_t)b * N + r) * D + c] = dx_acc[i][j];
    }
  }
}

size_t fwd_smem(int N, int D) {
  return sizeof(float) * ((size_t)N * (D + 1) + (size_t)kTQ * (D + 1) +
                          (size_t)N * D + 2 * (size_t)kTQ * N + 2 * N + kTQ);
}

size_t bwd_smem(int N, int D) {
  return sizeof(float) * (2 * (size_t)N * (D + 1) + (size_t)N * D +
                          2 * (size_t)N * N + 3 * N);
}

bool bad_shape(int B, int H, int N, int D) {
  return B <= 0 || H <= 0 || N <= 0 || N > 8 * kTY || D <= 0 || D > kMaxD;
}

}  // namespace

extern "C" int feta_fused_attn_fwd(const void* xa, const void* x,
                                   const void* cq, const void* ck,
                                   const void* c0, const void* vw,
                                   const void* pe, const void* deg,
                                   const void* mask, void* out, int B, int H,
                                   int N, int D, float inv_sqrt,
                                   void* stream) {
  const size_t smem = fwd_smem(N, D);
  if (bad_shape(B, H, N, D) || smem > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      fused_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int nq = (N + kTQ - 1) / kTQ;
  fused_fwd_kernel<<<B * nq, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)xa, (const float*)x, (const float*)cq, (const float*)ck,
      (const float*)c0, (const float*)vw, (const float*)pe,
      (const float*)deg, (const float*)mask, (float*)out, H, N, D, inv_sqrt);
  return (int)cudaGetLastError();
}

extern "C" int feta_fused_attn_bwd(const void* xa, const void* x,
                                   const void* cq, const void* ck,
                                   const void* c0, const void* vw,
                                   const void* pe, const void* deg,
                                   const void* mask, const void* g, void* dxa,
                                   void* dx, void* dcq, void* dck, void* dc0,
                                   void* dvw, int B, int H, int N, int D,
                                   float inv_sqrt, void* stream) {
  const size_t smem = bwd_smem(N, D);
  if (bad_shape(B, H, N, D) || smem > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      fused_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  fused_bwd_kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)xa, (const float*)x, (const float*)cq, (const float*)ck,
      (const float*)c0, (const float*)vw, (const float*)pe,
      (const float*)deg, (const float*)mask, (const float*)g, (float*)dxa,
      (float*)dx, (float*)dcq, (float*)dck, (float*)dc0, (float*)dvw, H, N,
      D, inv_sqrt);
  return (int)cudaGetLastError();
}

extern "C" const char* feta_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
