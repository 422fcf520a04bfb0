// Fused two-layer MLP, forward and backward, f32, for sm_90a.
//
// Replaces the TPU kernels feta_tmlr_tpu/ops/pallas/fused_mlp.py
// `_fwd_kernel` (launched by `_call_fwd`) and `_bwd_kernel` (`_call_bwd`).
// Per row r of x [R, din], with W1 [din, F], b1 [F], W2 [F, dout], b2 [dout]
// (all row-major):
//
//   pre = x W1 + b1,  h = relu(pre) * scale,  y = h W2 + b2
//   scale[r, j] = keep(seed, r, j) / (1 - rate)    (rate 0: scale = 1)
//
// and the backward for the cotangent g [R, dout]:
//
//   dh = (g W2^T) * scale * (pre > 0)
//   dx = dh W1^T,  dW1 = x^T dh,  db1 = sum_r dh,  dW2 = h^T g,  db2 = sum_r g
//
// The [R, F] hidden field is never written to device memory: both kernels
// recompute it from x (din is small, so the recompute costs din FMAs per
// hidden unit against the 2F·4 bytes a row of h would take).
//
// Dropout: the keep bit of (row r, hidden unit j) is
//   mix32(mix32(mix32(seed ^ 0x9e3779b9) ^ r) ^ j) < threshold
// with mix32 the lowbias32 integer mixer and threshold = round((1 - rate)
// 2^32) as in the TPU kernel's `_keep_threshold`. The mask depends on
// (seed, r, j) only, not on how rows are tiled, so the backward regenerates
// the forward's mask exactly, and the plain PyTorch version computes the same
// bits with integer tensor ops (ops/kernels/fused_mlp.py). The TPU kernel's
// own PRNG bits cannot be reproduced here; its tests hold the mask to the
// same invariants instead.
//
// What bounds it on the H100: f32 arithmetic on the CUDA cores. At the SAN
// eigen-PE head's shape (R = 40,960 rows, din = dout = 8, F = 2048) the
// forward is 2·R·F·(din + dout) = 2.68 GFLOP against ~3 MB of operands
// (0.040 ms at 67 TFLOP/s); the backward's five products are 6.71 GFLOP.
//
// Design.
//  - Widths: din and dout are zero-padded in registers to D, the bucket
//    8/16/32/64 of max(din, dout) (a template parameter), so any width up
//    to 64 runs; F is any size and R may be ragged (rows >= R load zeros
//    and store nothing).
//  - Forward (`fwd_kernel<D, RT>`): a block of 256 threads owns 32·RT rows;
//    lane l holds rows l, l + 32, ... and their x and y partials in
//    registers. W1, b1 and W2 are staged through shared memory in chunks of
//    2048 / D hidden units (~17 KB), and the eight warps split each chunk's
//    units, so every warp reads one unit's weights at a time (a broadcast)
//    and F is split across threads, not looped by one thread per row. The
//    eight per-warp y partials of a row are added in warp order at the end:
//    160 rows per block would give 1.2 blocks per SM at R = 40,960; 128 rows
//    per block give 320 blocks.
//  - Backward, three launches per call:
//    1. `bwd_dx_kernel<D, RT>`: the forward's layout; recomputes pre and
//       g W2^T per (row, unit) and accumulates dx per row in registers,
//       warps added in order at the end.
//    2. `bwd_dw_kernel<D, JT>`: one block per (slab of 256·JT hidden units,
//       split of rows). Each thread owns JT units and keeps their W1/W2
//       columns and their dW1/db1/dW2 sums in registers while it walks the
//       split's rows (staged 32 at a time in shared memory and read as
//       broadcasts), so the sums over rows need no reduction across
//       threads. Each split writes one partial of all weight gradients.
//    3. `sum_kernel`: adds the splits' partials in split order.
//    No float atomics anywhere: the gradients are bit-identical from run to
//    run on one card. The price of the two layouts is recompute: the
//    backward does 7 of the 5 minimal products (pre and g W2^T twice).
//
// C interface (ctypes): pointers and the stream as void*, returns the
// cudaError_t of the launches.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStageRows = 32;  // rows staged per step of bwd_dw_kernel

__host__ __device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7feb352dU;
  x ^= x >> 15;
  x *= 0x846ca68bU;
  x ^= x >> 16;
  return x;
}

struct Dropout {
  int on;              // rate > 0
  uint32_t seed_key;   // mix32(seed ^ 0x9e3779b9)
  uint32_t threshold;  // keep where the hash is below it
  float inv_keep;      // 1 / (1 - rate)

  __device__ __forceinline__ uint32_t row_key(int row) const {
    return mix32(seed_key ^ (uint32_t)row);
  }
  // scale of hidden unit j in the row whose key is rk
  __device__ __forceinline__ float scale(uint32_t rk, int j) const {
    if (!on) return 1.f;
    return mix32(rk ^ (uint32_t)j) < threshold ? inv_keep : 0.f;
  }
};

template <int D>
__host__ __device__ constexpr int chunk_units() {
  return 2048 / D;
}

// Stage hidden units [c0, c0 + FC) of W1 (transposed to [FC][D]), W2
// ([FC][D]) and b1 into shared memory, zero beyond din, dout and F.
template <int D>
__device__ __forceinline__ void stage_weights(
    float* w1s, float* w2s, float* b1s, const float* __restrict__ w1,
    const float* __restrict__ b1, const float* __restrict__ w2, int c0,
    int din, int F, int dout, int tid) {
  constexpr int FC = chunk_units<D>();
  for (int idx = tid; idx < FC * D; idx += kThreads) {
    const int k = idx / FC, jj = idx % FC, j = c0 + jj;
    w1s[jj * D + k] = (k < din && j < F) ? w1[(size_t)k * F + j] : 0.f;
    const int jj2 = idx / D, o = idx % D, j2 = c0 + jj2;
    w2s[idx] = (o < dout && j2 < F) ? w2[(size_t)j2 * dout + o] : 0.f;
  }
  for (int jj = tid; jj < FC; jj += kThreads)
    b1s[jj] = c0 + jj < F ? b1[c0 + jj] : 0.f;
}

template <int D, int RT>
__host__ __device__ constexpr size_t rowblock_smem() {
  return sizeof(float) * (2 * chunk_units<D>() * D + chunk_units<D>() +
                          kWarps * 32 * RT * D);
}

// y = dropout(relu(x W1 + b1)) W2 + b2 for 32·RT rows per block.
template <int D, int RT>
__global__ void __launch_bounds__(kThreads, 2)
fwd_kernel(const float* __restrict__ x, const float* __restrict__ w1,
           const float* __restrict__ b1, const float* __restrict__ w2,
           const float* __restrict__ b2, float* __restrict__ y, int R,
           int din, int F, int dout, Dropout drop) {
  constexpr int FC = chunk_units<D>();
  constexpr int ROWS = 32 * RT;
  extern __shared__ float smem[];
  float* w1s = smem;            // [FC][D]
  float* w2s = w1s + FC * D;    // [FC][D]
  float* b1s = w2s + FC * D;    // [FC]
  float* red = b1s + FC;        // [kWarps][ROWS][D] per-warp y partials
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r0 = blockIdx.x * ROWS;

  float xr[RT][D], acc[RT][D];
  uint32_t rk[RT];
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const int row = r0 + lane + 32 * i;
#pragma unroll
    for (int k = 0; k < D; ++k) {
      xr[i][k] = (row < R && k < din) ? x[(size_t)row * din + k] : 0.f;
      acc[i][k] = 0.f;
    }
    rk[i] = drop.row_key(row);
  }

  for (int c0 = 0; c0 < F; c0 += FC) {
    __syncthreads();
    stage_weights<D>(w1s, w2s, b1s, w1, b1, w2, c0, din, F, dout, tid);
    __syncthreads();
    const int nj = min(FC, F - c0);
    for (int jj = warp; jj < nj; jj += kWarps) {
      const float* w1j = w1s + jj * D;
      const float* w2j = w2s + jj * D;
      const float bj = b1s[jj];
#pragma unroll
      for (int i = 0; i < RT; ++i) {
        float pre = bj;
#pragma unroll
        for (int k = 0; k < D; ++k) pre = fmaf(xr[i][k], w1j[k], pre);
        const float h = fmaxf(pre, 0.f) * drop.scale(rk[i], c0 + jj);
#pragma unroll
        for (int o = 0; o < D; ++o) acc[i][o] = fmaf(h, w2j[o], acc[i][o]);
      }
    }
  }

  __syncthreads();
#pragma unroll
  for (int i = 0; i < RT; ++i)
#pragma unroll
    for (int o = 0; o < D; ++o)
      red[(warp * ROWS + lane + 32 * i) * D + o] = acc[i][o];
  __syncthreads();
  for (int idx = tid; idx < ROWS * D; idx += kThreads) {
    const int rl = idx / D, o = idx % D, row = r0 + rl;
    if (row < R && o < dout) {
      float s = 0.f;
      for (int w = 0; w < kWarps; ++w) s += red[(w * ROWS + rl) * D + o];
      y[(size_t)row * dout + o] = s + b2[o];
    }
  }
}

// dx = (((g W2^T) * scale * (pre > 0)) W1^T for 32·RT rows per block.
template <int D, int RT>
__global__ void __launch_bounds__(kThreads, 2)
bwd_dx_kernel(const float* __restrict__ x, const float* __restrict__ w1,
              const float* __restrict__ b1, const float* __restrict__ w2,
              const float* __restrict__ g, float* __restrict__ dx, int R,
              int din, int F, int dout, Dropout drop) {
  constexpr int FC = chunk_units<D>();
  constexpr int ROWS = 32 * RT;
  extern __shared__ float smem[];
  float* w1s = smem;
  float* w2s = w1s + FC * D;
  float* b1s = w2s + FC * D;
  float* red = b1s + FC;        // [kWarps][ROWS][D] per-warp dx partials
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r0 = blockIdx.x * ROWS;

  float xr[RT][D], gr[RT][D], acc[RT][D];
  uint32_t rk[RT];
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const int row = r0 + lane + 32 * i;
#pragma unroll
    for (int k = 0; k < D; ++k) {
      xr[i][k] = (row < R && k < din) ? x[(size_t)row * din + k] : 0.f;
      gr[i][k] = (row < R && k < dout) ? g[(size_t)row * dout + k] : 0.f;
      acc[i][k] = 0.f;
    }
    rk[i] = drop.row_key(row);
  }

  for (int c0 = 0; c0 < F; c0 += FC) {
    __syncthreads();
    stage_weights<D>(w1s, w2s, b1s, w1, b1, w2, c0, din, F, dout, tid);
    __syncthreads();
    const int nj = min(FC, F - c0);
    for (int jj = warp; jj < nj; jj += kWarps) {
      const float* w1j = w1s + jj * D;
      const float* w2j = w2s + jj * D;
      const float bj = b1s[jj];
#pragma unroll
      for (int i = 0; i < RT; ++i) {
        float pre = bj, dhd = 0.f;
#pragma unroll
        for (int k = 0; k < D; ++k) {
          pre = fmaf(xr[i][k], w1j[k], pre);
          dhd = fmaf(gr[i][k], w2j[k], dhd);
        }
        const float dh =
            pre > 0.f ? dhd * drop.scale(rk[i], c0 + jj) : 0.f;
#pragma unroll
        for (int k = 0; k < D; ++k) acc[i][k] = fmaf(dh, w1j[k], acc[i][k]);
      }
    }
  }

  __syncthreads();
#pragma unroll
  for (int i = 0; i < RT; ++i)
#pragma unroll
    for (int k = 0; k < D; ++k)
      red[(warp * ROWS + lane + 32 * i) * D + k] = acc[i][k];
  __syncthreads();
  for (int idx = tid; idx < ROWS * D; idx += kThreads) {
    const int rl = idx / D, k = idx % D, row = r0 + rl;
    if (row < R && k < din) {
      float s = 0.f;
      for (int w = 0; w < kWarps; ++w) s += red[(w * ROWS + rl) * D + k];
      dx[(size_t)row * din + k] = s;
    }
  }
}

// Weight-gradient partials of one (slab of 256·JT units, split of rows).
// part[split] holds [dW1 din·F | db1 F | dW2 F·dout | db2 dout].
template <int D, int JT>
__global__ void __launch_bounds__(kThreads, 2)
bwd_dw_kernel(const float* __restrict__ x, const float* __restrict__ w1,
              const float* __restrict__ b1, const float* __restrict__ w2,
              const float* __restrict__ g, float* __restrict__ part, int R,
              int din, int F, int dout, int rows_per_split, Dropout drop) {
  __shared__ float xs[kStageRows * D];
  __shared__ float gs[kStageRows * D];
  const int tid = threadIdx.x;
  const int slab = blockIdx.x, split = blockIdx.y;
  const size_t E = (size_t)din * F + F + (size_t)F * dout + dout;
  float* out = part + split * E;

  int jd[JT];
  float w1r[JT][D], w2r[JT][D], b1r[JT];
  float aw1[JT][D], aw2[JT][D], ab1[JT];
#pragma unroll
  for (int u = 0; u < JT; ++u) {
    const int j = slab * kThreads * JT + tid + kThreads * u;
    jd[u] = j;
    const bool in = j < F;
#pragma unroll
    for (int k = 0; k < D; ++k) {
      w1r[u][k] = (in && k < din) ? w1[(size_t)k * F + j] : 0.f;
      w2r[u][k] = (in && k < dout) ? w2[(size_t)j * dout + k] : 0.f;
      aw1[u][k] = 0.f;
      aw2[u][k] = 0.f;
    }
    b1r[u] = in ? b1[j] : 0.f;
    ab1[u] = 0.f;
  }
  float ab2 = 0.f;  // db2[tid] for tid < dout, slab 0

  const int rbeg = split * rows_per_split;
  const int rend = min(R, rbeg + rows_per_split);
  for (int t0 = rbeg; t0 < rend; t0 += kStageRows) {
    __syncthreads();
    for (int idx = tid; idx < kStageRows * D; idx += kThreads) {
      const int row = t0 + idx / D, k = idx % D;
      xs[idx] = (row < rend && k < din) ? x[(size_t)row * din + k] : 0.f;
      gs[idx] = (row < rend && k < dout) ? g[(size_t)row * dout + k] : 0.f;
    }
    __syncthreads();
    const int nr = min(kStageRows, rend - t0);
    for (int rl = 0; rl < nr; ++rl) {
      const uint32_t rk = drop.row_key(t0 + rl);
      float xv[D], gv[D];
#pragma unroll
      for (int k = 0; k < D; ++k) {
        xv[k] = xs[rl * D + k];
        gv[k] = gs[rl * D + k];
      }
#pragma unroll
      for (int u = 0; u < JT; ++u) {
        float pre = b1r[u], dhd = 0.f;
#pragma unroll
        for (int k = 0; k < D; ++k) {
          pre = fmaf(xv[k], w1r[u][k], pre);
          dhd = fmaf(gv[k], w2r[u][k], dhd);
        }
        const float scale = drop.scale(rk, jd[u]);
        const float hd = fmaxf(pre, 0.f) * scale;
        const float dh = pre > 0.f ? dhd * scale : 0.f;
#pragma unroll
        for (int k = 0; k < D; ++k) {
          aw1[u][k] = fmaf(xv[k], dh, aw1[u][k]);
          aw2[u][k] = fmaf(hd, gv[k], aw2[u][k]);
        }
        ab1[u] += dh;
      }
      if (slab == 0 && tid < dout) ab2 += gs[rl * D + tid];
    }
  }

#pragma unroll
  for (int u = 0; u < JT; ++u) {
    const int j = jd[u];
    if (j >= F) continue;
#pragma unroll
    for (int k = 0; k < D; ++k) {
      if (k < din) out[(size_t)k * F + j] = aw1[u][k];
      if (k < dout) out[(size_t)din * F + F + (size_t)j * dout + k] = aw2[u][k];
    }
    out[(size_t)din * F + j] = ab1[u];
  }
  if (slab == 0 && tid < dout)
    out[(size_t)din * F + F + (size_t)F * dout + tid] = ab2;
}

// grads[e] = sum over splits, in split order, of part[split][e].
__global__ void sum_kernel(const float* __restrict__ part,
                           float* __restrict__ grads, int E, int n_splits) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= E) return;
  float s = 0.f;
  for (int sp = 0; sp < n_splits; ++sp) s += part[(size_t)sp * E + e];
  grads[e] = s;
}

int width_bucket(int din, int dout) {
  const int d = din > dout ? din : dout;
  if (d <= 0) return 0;
  if (d <= 8) return 8;
  if (d <= 16) return 16;
  if (d <= 32) return 32;
  if (d <= 64) return 64;
  return 0;
}

constexpr int dw_units(int D) { return D == 8 ? 2 : 1; }

Dropout make_dropout(int on, unsigned seed, unsigned threshold,
                     float inv_keep) {
  return Dropout{on, mix32((uint32_t)seed ^ 0x9e3779b9U), threshold,
                 inv_keep};
}

template <int D, int RT>
cudaError_t launch_fwd(const float* x, const float* w1, const float* b1,
                       const float* w2, const float* b2, float* y, int R,
                       int din, int F, int dout, Dropout drop,
                       cudaStream_t stream) {
  const size_t smem = rowblock_smem<D, RT>();
  cudaError_t err = cudaFuncSetAttribute(
      fwd_kernel<D, RT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const int blocks = (R + 32 * RT - 1) / (32 * RT);
  fwd_kernel<D, RT><<<blocks, kThreads, smem, stream>>>(
      x, w1, b1, w2, b2, y, R, din, F, dout, drop);
  return cudaGetLastError();
}

template <int D, int RT>
cudaError_t launch_bwd(const float* x, const float* w1, const float* b1,
                       const float* w2, const float* g, float* dx,
                       float* part, float* grads, int R, int din, int F,
                       int dout, int n_splits, Dropout drop,
                       cudaStream_t stream) {
  const size_t smem = rowblock_smem<D, RT>();
  cudaError_t err = cudaFuncSetAttribute(
      bwd_dx_kernel<D, RT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const int blocks = (R + 32 * RT - 1) / (32 * RT);
  bwd_dx_kernel<D, RT><<<blocks, kThreads, smem, stream>>>(
      x, w1, b1, w2, g, dx, R, din, F, dout, drop);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  constexpr int JT = dw_units(D);
  const int slabs = (F + kThreads * JT - 1) / (kThreads * JT);
  const int rows_per_split = (R + n_splits - 1) / n_splits;
  bwd_dw_kernel<D, JT><<<dim3(slabs, n_splits), kThreads, 0, stream>>>(
      x, w1, b1, w2, g, part, R, din, F, dout, rows_per_split, drop);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const int E = din * F + F + F * dout + dout;
  sum_kernel<<<(E + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      part, grads, E, n_splits);
  return cudaGetLastError();
}

}  // namespace

// Number of row splits of the backward's weight-gradient pass (the wrapper
// allocates that many partials of din·F + F + F·dout + dout floats): about
// two blocks per SM in all, and at least kStageRows rows per split.
extern "C" int feta_fused_mlp_bwd_splits(int R, int din, int F, int dout,
                                         int n_sm) {
  const int D = width_bucket(din, dout);
  if (D == 0 || R <= 0 || F <= 0 || n_sm <= 0) return 0;
  const int units = kThreads * dw_units(D);
  const int slabs = (F + units - 1) / units;
  int splits = (2 * n_sm + slabs - 1) / slabs;
  const int most = (R + kStageRows - 1) / kStageRows;
  if (splits > most) splits = most;
  return splits < 1 ? 1 : splits;
}

extern "C" int feta_fused_mlp_fwd(const void* x, const void* w1,
                                  const void* b1, const void* w2,
                                  const void* b2, void* y, int R, int din,
                                  int F, int dout, int drop_on, unsigned seed,
                                  unsigned threshold, float inv_keep,
                                  void* stream) {
  const int D = width_bucket(din, dout);
  if (D == 0 || R <= 0 || F <= 0) return (int)cudaErrorInvalidValue;
  const Dropout drop = make_dropout(drop_on, seed, threshold, inv_keep);
  const auto* xf = (const float*)x;
  const auto* w1f = (const float*)w1;
  const auto* b1f = (const float*)b1;
  const auto* w2f = (const float*)w2;
  const auto* b2f = (const float*)b2;
  auto* yf = (float*)y;
  auto s = (cudaStream_t)stream;
  switch (D) {
    case 8:
      return (int)launch_fwd<8, 4>(xf, w1f, b1f, w2f, b2f, yf, R, din, F,
                                   dout, drop, s);
    case 16:
      return (int)launch_fwd<16, 2>(xf, w1f, b1f, w2f, b2f, yf, R, din, F,
                                    dout, drop, s);
    case 32:
      return (int)launch_fwd<32, 1>(xf, w1f, b1f, w2f, b2f, yf, R, din, F,
                                    dout, drop, s);
    default:
      return (int)launch_fwd<64, 1>(xf, w1f, b1f, w2f, b2f, yf, R, din, F,
                                    dout, drop, s);
  }
}

extern "C" int feta_fused_mlp_bwd(const void* x, const void* w1,
                                  const void* b1, const void* w2,
                                  const void* g, void* dx, void* part,
                                  void* grads, int R, int din, int F,
                                  int dout, int n_splits, int drop_on,
                                  unsigned seed, unsigned threshold,
                                  float inv_keep, void* stream) {
  const int D = width_bucket(din, dout);
  if (D == 0 || R <= 0 || F <= 0 || n_splits <= 0)
    return (int)cudaErrorInvalidValue;
  const Dropout drop = make_dropout(drop_on, seed, threshold, inv_keep);
  const auto* xf = (const float*)x;
  const auto* w1f = (const float*)w1;
  const auto* b1f = (const float*)b1;
  const auto* w2f = (const float*)w2;
  const auto* gf = (const float*)g;
  auto* dxf = (float*)dx;
  auto* pf = (float*)part;
  auto* gr = (float*)grads;
  auto s = (cudaStream_t)stream;
  switch (D) {
    case 8:
      return (int)launch_bwd<8, 2>(xf, w1f, b1f, w2f, gf, dxf, pf, gr, R, din,
                                   F, dout, n_splits, drop, s);
    case 16:
      return (int)launch_bwd<16, 1>(xf, w1f, b1f, w2f, gf, dxf, pf, gr, R,
                                    din, F, dout, n_splits, drop, s);
    case 32:
      return (int)launch_bwd<32, 1>(xf, w1f, b1f, w2f, gf, dxf, pf, gr, R,
                                    din, F, dout, n_splits, drop, s);
    default:
      return (int)launch_bwd<64, 1>(xf, w1f, b1f, w2f, gf, dxf, pf, gr, R,
                                    din, F, dout, n_splits, drop, s);
  }
}

extern "C" const char* feta_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
