// The backward query pass of GraphiT attention on the H100's tensor cores,
// one kernel body for both grids: flash_bwd.cu launches it unfolded
// (flash_bwd_q, TPU `_bwd_q_kernel`), flash_hf.cu head-folded
// (flash_bwd_q_hf, TPU `_bwd_q_kernel_hf`). It computes
//
//   dxa_h = ds_h @ x,    dcq_h = sum_j ds_h
//
// with ds recomputed from the forward's row statistics (the formulas are in
// flash_bwd.cu's note and graphit_tile.cuh's `grad_score`).
//
// Strips, grids and staging: strips.cuh. Two warps a strip, warp 2 s + u.
//
// Per key tile, warp (s, u), the mma's M the strip's 16 queries:
//   1. keys 16 u .. 16 u + 15 (two n-tiles): the score s as the forwards'
//      FMA chain (graphit_tile.cuh's dot4 from float4 loads of the staged
//      xa and x rows) at the thread's C-fragment positions, queries g (+8)
//      and keys 2 t (+1), bit for bit the score whose exp(s - m) / se the
//      forward normalised; ga = g_h vw_h^T on the tensor cores in 3xTF32
//      (mma_tf32.cuh; A g's rows [q][dv], B vw's rows [key][dv], a fresh
//      fragment per k-step); then ds = grad_score(...) in the accumulators'
//      registers, written to shared memory [q][key], and each row's sum of
//      the tile's ds, a fresh partial, into a RunSum (dcq);
//   2. after a barrier (the strip's ds complete): dxa of its 16 queries x
//      columns 32 u .. 32 u + 31 (four n-tiles) += ds x over K = the tile's
//      32 keys in 3xTF32, A the strip's ds rows, B the staged x tile
//      [key][d]; the tile's product into a fresh partial that is then
//      added to the running dxa (flash_fwd.cu's note on summation order).
// At the end dcq adds the 4 lanes of a row (fixed xor order), then the
// strip's two warps in order. No float atomics: bit-identical runs.
//
// Staging (strips.cuh). Once: the strips' xa and g rows [16 S][kLD]. Per
// key tile, a two-stage ring of the tile's x, pe, ck, deg and key mask:
// tile t + 1 loads while tile t computes. vw [V][32][kLD] has one buffer,
// refilled for tile t + 1 after phase 1 of tile t and landing during its
// phase 2: a second one would take the folded block past the SM's 227 KB
// at H=8. Shared memory at D = DV = 64: unfolded 91,904 bytes (two blocks
// an SM, 128 registers a thread), folded 183,808 bytes at H=8 (one block
// of 16 warps an SM).
//
// Wide rows (kW = 128, the unfolded grid at D or DV > 64): xa, g, x and
// vw rows of 128 floats (stride 132), the score's chain over all D
// columns and ga over all DV, and a grid axis of kChunk = 64 columns of
// dxa (strips.cuh): each chunk's block recomputes ds (the same bits) and
// takes its 64 columns of ds·x; chunk 0 writes dcq. Shared memory 149,248
// bytes (one block an SM).
//
// What bounds it: instruction issue and mma.sync's TF32 rate. A warp's
// tile is 512 score FMAs beside 96 TF32 mma.sync (48 a product) and their
// operand splits (mma_tf32.cuh); the bound of what it issues is the
// score's FMAs at 67 TFLOP/s beside the two 3xTF32 products at the TF32
// peak (PERF.md). Rows and keys >= N contribute exactly 0 and are not
// stored; rows of width w < 64 are zero-filled to 64, so the K edge of
// D and DV not multiples of 8 adds exact zeros.
//
// bf16 operands (the bf16 compute policy; flash_bwd.cu's bf16 entry
// points, the unfolded grid only): xa, x, vw and g bf16, pe and deg bf16
// or float, staged into the float tiles converted (mma_tf32.cuh's note).
// ga is one TF32 product of bf16-exact operands; ds is rounded to bf16
// for ds·x (JAX's cast of ds to x's dtype), which is one TF32 product
// too, while dcq sums the unrounded ds; dxa is rounded once to bf16.

#pragma once

#include <cuda_runtime.h>

#include "graphit_tile.cuh"
#include "mma_tf32.cuh"
#include "strips.cuh"

namespace bwdq {

using namespace strips;

constexpr int kLDS = kKeys + 4;    // ds [query][key]: A loads conflict-free

template <int kW>
__host__ __device__ inline size_t smem_floats(Shape sh) {
  const size_t rows = (size_t)sh.S * kStrip;
  return 2 * rows * ld(kW) + rows * kLDS + vw_floats<kW>(sh) +
         2 * (size_t)key_floats<kW>(sh) + 2 * rows;
}

// kW: the widest rows (strips.cuh), kMaxW or (unfolded) kWideW; TV, TM:
// the types of xa, x, vw, g, dxa and of pe, deg (the note on bf16
// operands above)
template <bool kFold, int kW, class TV = float, class TM = float>
__global__ void __launch_bounds__(kFold ? 64 * kMaxHeads : 256,
                                  kFold ? 1 : 2)
bwd_q_kernel(graphit::OperandsT<TV, TM> op, TV* __restrict__ dxa,
             float* __restrict__ dcq, int H, int N, int D, int DV,
             float inv_sqrt) {
  static_assert(kW == kMaxW || (!kFold && kW == kWideW), "row width");
  constexpr int kLDX = ld(kW);
  constexpr bool kChunked = kW > kMaxW;
  constexpr bool kBf = tc::is_bf16<TV>();
  extern __shared__ float smem[];
  const Shape sh = shape(kFold, H);
  const int rows = sh.S * kStrip, stage = key_floats<kW>(sh);
  float* xas = smem;                     // [16 S][kLDX] the strips' xa
  float* gs = xas + rows * kLDX;         // [16 S][kLDX] their cotangents
  float* dss = gs + rows * kLDX;         // [16 S][kLDS] ds of the tile
  float* vws = dss + rows * kLDS;        // [V][32][kLDX] its values
  float* ring = vws + vw_floats<kW>(sh);
  float* red = ring + 2 * stage;         // [2][16 S]    dcq of each warp

  const Block blk = block_of<kFold, kChunked>(H, N, chunks(kW, D));
  const int col0 = kChunked ? blk.chunk * kChunk : 0;   // dxa's columns
  const int tid = threadIdx.x, warp = tid / 32;
  const int g = tc::lane_g(), t = tc::lane_t();
  const int s = warp >> 1, u = warp & 1;
  const int hs = blk.head(s), qs0 = blk.first(s);
  const size_t bhs = (size_t)blk.b * H + hs;

  // the query side, once; then key tile 0 and its values
  stage_strips<kW>(xas, blk, sh, op.xa, D, H, N, op.x);
  stage_strips<kW>(gs, blk, sh, op.g, DV, H, N, op.x);
  stage_keys<kW>(ring, blk, sh, op, 0, H, N, D);
  stage_vw<kW>(vws, blk, sh, op, 0, H, N, DV, 0, DV);
  tc::cp_async_commit();

  // the row constants of the thread's queries qs0 + g (+8)
  float cq[2], m[2], ise[2], qa[2], beta[2], c[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int q = qs0 + g + 8 * e;
    const bool in = q < N;
    const size_t row = bhs * N + (in ? q : 0);
    cq[e] = in ? op.cq[row] : 0.f;
    m[e] = in ? op.m[row] : 0.f;
    ise[e] = in ? op.ise[row] : 0.f;
    qa[e] = in ? op.qa[row] : 0.f;
    beta[e] = in ? op.beta[row] : 0.f;
    c[e] = in ? op.c[row] : 0.f;
  }
  const float c0h = op.c0[hs];
  const int D8 = tc::round8(D), DV8 = tc::round8(DV);

  // C fragments of dxa: rows g (+8), columns 32 u + 8 n + 2 t (+1)
  float acc[4][4] = {};
  graphit::RunSum dsum[2];

  const int nt = (N + kKeys - 1) / kKeys;
  for (int it = 0; it < nt; ++it) {
    const int k0 = it * kKeys;
    tc::cp_async_wait_all();
    __syncthreads();  // tile `it` visible; every warp done with it - 1
    if (it + 1 < nt) {
      stage_keys<kW>(ring + ((it + 1) & 1) * stage, blk, sh, op, k0 + kKeys,
                     H, N, D);
      tc::cp_async_commit();
    }
    const float* xst = ring + (it & 1) * stage;
    const float* pst = xst + kKeys * kLDX + (kFold ? 0 : kStrip * s) * kLDP;
    const float* cks = xst + kKeys * kLDX + sh.P * kLDP;
    const float* dgs = cks + sh.V * kKeys;
    const float* kms = dgs + kKeys;
    if (kFold) cks += s * kKeys;

    // 1. score (FMA chain) and ga (tensor cores), 16 queries x 16 keys
    float sc[2][4] = {}, ga[2][4] = {};
    const float* xq = xas + (kStrip * s + g) * kLDX;
    const float* xk = xst + (16 * u + 2 * t) * kLDX;
    const float* gq = gs + kStrip * s * kLDX;
    const float* vk = vws + (kFold ? s : 0) * kKeys * kLDX;
#pragma unroll
    for (int kk = 0; kk < kW; kk += 8) {
      if (kk < DV8) {
        const tc::FragA a = tc::load_a(gq, kLDX, 0, kk);
#pragma unroll
        for (int n = 0; n < 2; ++n)
          tc::mma_add<kBf>(ga[n], a,
                           tc::load_b_nk(vk, kLDX, 16 * u + 8 * n, kk));
      }
      if (kk < D8) {
#pragma unroll
        for (int k = kk; k < kk + 8; k += 4) {
          const float4 qv[2] = {graphit::ld4(xq + k),
                                graphit::ld4(xq + 8 * kLDX + k)};
#pragma unroll
          for (int n = 0; n < 2; ++n)
#pragma unroll
            for (int f = 0; f < 2; ++f) {
              const float4 kv = graphit::ld4(xk + (8 * n + f) * kLDX + k);
#pragma unroll
              for (int e = 0; e < 2; ++e)
                sc[n][2 * e + f] = graphit::dot4(qv[e], kv, sc[n][2 * e + f]);
            }
        }
      }
    }
    float tile[2] = {0.f, 0.f};   // the tile's ds of each row: fresh
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int ql = g + 8 * e, kl = 16 * u + 8 * n + 2 * t;
        const float2 pe2 = op.pe ? *reinterpret_cast<const float2*>(
                                      pst + ql * kLDP + kl)
                                : make_float2(1.f, 1.f);
        float d2[2];
#pragma unroll
        for (int f = 0; f < 2; ++f) {
          float d = 0.f, attn;
          if (qs0 + ql < N && k0 + kl + f < N) {
            const float pd = (f ? pe2.y : pe2.x) *
                             (op.deg ? dgs[kl + f] : 1.f);
            d = graphit::grad_score(sc[n][2 * e + f], cq[e], cks[kl + f],
                                    c0h, inv_sqrt, kms[kl + f], m[e], ise[e],
                                    qa[e], beta[e], c[e], pd,
                                    ga[n][2 * e + f], attn);
          }
          tile[e] += d;
          // ds x takes ds rounded to bf16 where x is (JAX's cast of ds to
          // x's dtype); dcq sums it unrounded
          d2[f] = kBf ? tc::round_bf16(d) : d;
        }
        *reinterpret_cast<float2*>(dss + (kStrip * s + ql) * kLDS + kl) =
            make_float2(d2[0], d2[1]);
      }
    dsum[0].add(tile[0], it);
    dsum[1].add(tile[1], it);
    __syncthreads();  // every strip's ds complete; vw no longer read
    if (it + 1 < nt) {
      stage_vw<kW>(vws, blk, sh, op, k0 + kKeys, H, N, DV, 0, DV);
      tc::cp_async_commit();
    }

    // 2. dxa += ds x over the tile's keys, into a fresh partial
    const float* dsa = dss + kStrip * s * kLDS;
    float part[4][4] = {};
#pragma unroll
    for (int kk = 0; kk < kKeys; kk += 8) {
      const tc::FragA a = tc::load_a(dsa, kLDS, 0, kk);
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const int c0 = col0 + 32 * u + 8 * n;
        if (c0 < D8)
          tc::mma_add<kBf>(part[n], a, tc::load_b_kn(xst, kLDX, kk, c0));
      }
    }
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[n][i] += part[n][i];
  }

#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int q = qs0 + g + 8 * (i >> 1);
      const int col = col0 + 32 * u + 8 * n + 2 * t + (i & 1);
      if (q < N && col < D)
        tc::store(dxa + (bhs * N + q) * D + col, acc[n][i]);
    }
  // dcq: each thread's rows, then the 4 lanes of a row, then the two warps
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    float v = dsum[e].sum();
    v += __shfl_xor_sync(0xffffffffu, v, 1);
    v += __shfl_xor_sync(0xffffffffu, v, 2);
    if (t == 0) red[u * rows + kStrip * s + g + 8 * e] = v;
  }
  __syncthreads();
  for (int r = tid; blk.chunk == 0 && r < rows; r += blockDim.x) {
    const int sr = r >> 4, q = blk.first(sr) + (r & 15);
    if (q < N)
      dcq[((size_t)blk.b * H + blk.head(sr)) * N + q] =
          red[r] + red[rows + r];
  }
}

// Launch either grid at row width kW: blocks of 2 S warps, times the
// chunks of dxa's columns, dynamic shared memory set first.
template <bool kFold, int kW = kMaxW, class TV = float, class TM = float>
int launch(graphit::OperandsT<TV, TM> op, TV* dxa, float* dcq, int B, int H,
           int N, int D, int DV, float inv_sqrt, cudaStream_t stream) {
  const Shape sh = shape(kFold, H);
  const size_t smem = sizeof(float) * smem_floats<kW>(sh);
  cudaError_t err = cudaFuncSetAttribute(
      bwd_q_kernel<kFold, kW, TV, TM>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  bwd_q_kernel<kFold, kW, TV, TM>
      <<<blocks(kFold, B, H, N, chunks(kW, D)), 64 * sh.S, smem, stream>>>(
          op, dxa, dcq, H, N, D, DV, inv_sqrt);
  return (int)cudaGetLastError();
}

}  // namespace bwdq
