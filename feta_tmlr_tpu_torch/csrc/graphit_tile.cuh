// Score tiles of GraphiT attention, shared by flash_fwd.cu, flash_bwd.cu,
// colstat.cu and flash_hf.cu (which uses only the score functions); the
// backward passes take `dot4`, `score`, `grad_score`, their `Operands` and
// `RunSum` (their other products run on the tensor cores, mma_tf32.cuh).
//
// One 256-thread block works on a 64-query x 64-key tile. Thread
// (tx, ty) = (tid % 16, tid / 16) owns rows ty + 16 i and key columns
// tx + 16 j (i, j < 4): the 16 threads of a row are 16 consecutive lanes
// of one warp, so a row reduction is four __shfl_xor_sync steps.
// Operands are staged transposed in shared memory with a stride of 65, so
// the warp's reads along the tile are conflict-free.
//
// The score of query i and key j is the JAX package's `_score_block`:
//   s = (xa_h[i] . x[j] + cq[i] + ck[j] + c0) * inv_sqrt,
//   -1e30 where key j is padding (kmask 0).

#pragma once

#include <cuda_runtime.h>

namespace graphit {

constexpr int kBQ = 64;            // query rows per tile
constexpr int kBK = 64;            // key columns per tile
constexpr int kTX = 16;
constexpr int kTY = 16;
constexpr int kThreads = kTX * kTY;
constexpr int kRows = kBQ / kTY;   // rows per thread
constexpr int kCols = kBK / kTX;   // key columns per thread
constexpr int kLDQ = kBQ + 1;      // padded strides
constexpr int kLDK = kBK + 1;
constexpr float kMaskedScore = -1e30f;
constexpr float kEps = 1e-9f;
static_assert(kBQ == kBK, "stage_transposed stages square tiles");

// dst[k * ld + r] = src[(row0 + r) * D + k] for the kBQ rows of a tile,
// zero beyond the ragged edge N.
__device__ __forceinline__ void stage_transposed(float* dst, int ld,
                                                 const float* src, int row0,
                                                 int N, int D, int tid) {
  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, k = i % D, row = row0 + r;
    dst[k * ld + r] = row < N ? src[(size_t)row * D + k] : 0.f;
  }
}

// s[i][j] = xa_h[row ty + 16 i] . x[key tx + 16 j] from the staged tiles.
__device__ __forceinline__ void tile_dot(const float* xaT, const float* xT,
                                         int D, int tx, int ty,
                                         float (&s)[kRows][kCols]) {
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j) s[i][j] = 0.f;
  for (int k = 0; k < D; ++k) {
    float a[kRows], b[kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i) a[i] = xaT[k * kLDQ + ty + kTY * i];
#pragma unroll
    for (int j = 0; j < kCols; ++j) b[j] = xT[k * kLDK + tx + kTX * j];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
  }
}

// s + q·k over four consecutive k, one FMA at a time in order: called for
// k = 0, 4, ... from s = 0 it is `tile_dot`'s chain (and flash_hf.cu's
// `micro_dot`'s) bit for bit, so a backward pass that recomputes the score
// with it gets the forward's score exactly (columns past D must be zero).
__device__ __forceinline__ float dot4(float4 q, float4 k, float s) {
  s = fmaf(q.x, k.x, s);
  s = fmaf(q.y, k.y, s);
  s = fmaf(q.z, k.z, s);
  return fmaf(q.w, k.w, s);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float score(float dot, float cq, float ck,
                                       float c0, float inv_sqrt, float km) {
  return km > 0.f ? (dot + cq + ck + c0) * inv_sqrt : kMaskedScore;
}

// The backward's ds (and attn) of one score, recomputed from the forward's
// row maximum m and the row constants ise, qa, beta, c (flash_bwd.cu's
// note); pd = pe[i, j] * deg[j], ga = g_h[i] . vw_h[j].
__device__ __forceinline__ float grad_score(float dot, float cq, float ck,
                                            float c0, float inv_sqrt,
                                            float km, float m, float ise,
                                            float qa, float beta, float c,
                                            float pd, float ga, float& attn) {
  const float a = expf(score(dot, cq, ck, c0, inv_sqrt, km) - m) * ise;
  attn = a * pd * qa * km;
  const float du = ga * km * qa - beta;
  return a * (du * pd - c) * inv_sqrt;
}

// The backward passes' operands (flash_bwd.cu's note): the forward's, the
// per-head cotangent g and the row statistics and constants.
struct Operands {
  const float *xa, *x, *cq, *ck, *c0, *vw, *pe, *deg, *mask, *g;
  const float *m, *ise, *qa, *beta, *c;
};

inline Operands operands(const void* xa, const void* x, const void* cq,
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

// A thread's sum over the tiles of a block's loop in a bounded order (dcq
// in the query passes, dck in the key passes): each tile's partial, a
// fresh sum of the tile's terms, joins a run of kRunTiles tiles, and each
// complete run joins the total. One f32 chain over every term of 2048
// queries put dck at 1.8x the CPU float32 route's error (PERF.md); here
// the longest chain is kRunTiles partials, or N / (tile * kRunTiles) runs.
constexpr int kRunTiles = 8;

struct RunSum {
  float total = 0.f, run = 0.f;
  // `tile`: the partial's index in the loop, 0, 1, ...
  __device__ __forceinline__ void add(float partial, int tile) {
    run += partial;
    if (tile % kRunTiles == kRunTiles - 1) {
      total += run;
      run = 0.f;
    }
  }
  __device__ __forceinline__ float sum() const { return total + run; }
};

}  // namespace graphit
