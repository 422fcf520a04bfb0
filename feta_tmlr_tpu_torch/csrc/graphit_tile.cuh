// Score tiles of GraphiT attention. The forwards' body fwd.cuh, colstat.cu
// and the backward passes (flash_bwd.cu, flash_hf.cu, bwd_q.cuh) take
// `dot4` and `score`, colstat and the backward passes `RunSum`, the
// backward passes `Operands` and `grad_score` (their other products run on
// the tensor cores, mma_tf32.cuh).
// Each computes its score at the mma C-fragment positions as one FMA chain
// over k in order, so every kernel gets the forward's score bit for bit.
//
// The score of query i and key j is the JAX package's `_score_block`:
//   s = (xa_h[i] . x[j] + cq[i] + ck[j] + c0) * inv_sqrt,
//   -1e30 where key j is padding (kmask 0).

#pragma once

#include <cuda_runtime.h>

namespace graphit {

constexpr int kThreads = 256;      // the key passes' and colstat's blocks
constexpr float kMaskedScore = -1e30f;
constexpr float kEps = 1e-9f;

// s + q·k over four consecutive k, one FMA at a time in order: called for
// k = 0, 4, ... from s = 0 it is the score's FMA chain. The forwards
// (fwd.cuh) take their score from it, so colstat.cu and a backward pass
// that recomputes the score get the forward's score exactly (columns past
// D must be zero).
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
// per-head cotangent g and the row statistics and constants. TV is the type
// of xa, x, vw and g, TM that of pe and deg: float, or bf16 under the bf16
// compute policy (TV bf16 with TM bf16 or float; mma_tf32.cuh's note).
// The masks, cq, ck, c0 and the statistics stay float.
template <class TV, class TM>
struct OperandsT {
  const TV *xa, *x;
  const float *cq, *ck, *c0;
  const TV* vw;
  const TM *pe, *deg;
  const float* mask;
  const TV* g;
  const float *m, *ise, *qa, *beta, *c;
};
using Operands = OperandsT<float, float>;

template <class TV = float, class TM = float>
inline OperandsT<TV, TM> operands(const void* xa, const void* x,
                                  const void* cq, const void* ck,
                                  const void* c0, const void* vw,
                                  const void* pe, const void* deg,
                                  const void* mask, const void* g,
                                  const void* m, const void* ise,
                                  const void* qa, const void* beta,
                                  const void* c) {
  return OperandsT<TV, TM>{
      (const TV*)xa,     (const TV*)x,      (const float*)cq,
      (const float*)ck,  (const float*)c0,  (const TV*)vw,
      (const TM*)pe,     (const TM*)deg,    (const float*)mask,
      (const TV*)g,      (const float*)m,   (const float*)ise,
      (const float*)qa,  (const float*)beta, (const float*)c};
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
