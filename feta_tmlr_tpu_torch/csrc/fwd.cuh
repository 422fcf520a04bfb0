// The online-softmax GraphiT attention forward on the H100, one kernel body
// for both grids: flash_fwd.cu launches it unfolded (flash_fwd, TPU
// `_fwd_kernel`), flash_hf.cu head-folded (flash_fwd_hf, TPU
// `_fwd_kernel_hf`). It computes outh [B,H,N,DV] and the row statistics m,
// se, su [B,H,N] (the formulas are in flash_fwd.cu's note).
//
// Strips, grids and staging: strips.cuh. Two warps a strip, warp 2 s + u.
// Per 32-key tile, warp (s, u) takes keys 16 u .. 16 u + 15 for the strip's
// 16 queries (the mma's M):
//   1. the score s as the FMA chain graphit_tile.cuh's dot4 (float4 loads
//      of the staged xa and x rows) at the thread's C-fragment positions,
//      queries g (+8) and keys 2 t (+1): the chain that colstat.cu and the
//      backward passes repeat, bit for bit, to normalise by m and se;
//   2. the online softmax in registers: the warp's running row max m (the
//      4 lanes of a row agree), e = exp(s - m), the tile's se and su as
//      fresh partials (the thread's 4 keys in order, then the lanes in a
//      fixed xor order) added to the rescaled running sums, and
//      P = e·pe·deg·kmask;
//   3. P·V on the tensor cores in 3xTF32 (mma_tf32.cuh) with P in
//      registers: the score's C fragment is the A fragment of P·V with its
//      columns permuted (`frag_a_from_c`; vw's rows alike,
//      `load_b_kn_pairs`); a fresh fragment per k-step, the first one the
//      tile's fresh partial and the second added to it, then
//      acc = acc·scale + part.
// The running sums se, su and acc are kept in runs of 8 tiles (the note
// at their declaration). A warp whose keys of the last tile lie past N
// skips them. At the end the strip's two warps join in a fixed order:
// m = max(m_0, m_1) and each side rescaled by exp(m_u - m). No float
// atomics: bit-identical runs, and the folded grid gives the unfolded
// one's bits.
//
// Staging: the strips' xa rows once; per key tile a two-stage ring of x,
// pe, ck, deg, the key mask and vw (strips.cuh): tile t + 1 loads while
// tile t computes, one barrier a tile. Shared memory at D = DV = 64:
// unfolded 73,472 bytes (two blocks an SM, 128 registers a thread, 48
// bytes of spill), folded 199,168 bytes at H=8 (one block of 16 warps an
// SM).
//
// Wide rows (kW = 128, the unfolded grid at D or DV > 64): the xa and x
// rows are 128 floats (stride 132), the score's chain runs over all D
// columns, and the grid gains an axis of kChunk = 64 value columns
// (strips.cuh), each block staging only its chunk of vw and writing its
// chunk of outh; every chunk's block computes the same m, se and su bit
// for bit (the same chain, sums and order), and chunk 0 writes them. So
// at DV = 128 the score and the softmax are computed twice, the price of
// keeping the accumulator at acc[8][4]. Shared memory 106,240 bytes (two
// blocks an SM).
//
// What bounds it: a warp's tile is 512 score FMAs a thread beside 48 TF32
// mma.sync (P·V) and their operand splits, one after the other. The bound
// of what it issues is the score's FMAs at 67 TFLOP/s beside one 3xTF32
// product at the TF32 peak. Variants with a phase removed (PERF.md) put
// most of the time in the score, bound by its FMAs' issue and not by its
// float4 loads, then in P·V, bound by mma.sync's TF32 rate, with the
// staging a small share. Keys >= N get e = 0 and never enter m; rows >= N
// are not stored; D and DV not multiples of 8 add exact zeros at the K
// edge (zero-filled columns).
//
// bf16 operands (the bf16 compute policy; flash_fwd.cu's bf16 entry
// points, the unfolded grid only): xa, x and vw bf16, pe and deg bf16 or
// float, staged into the float tiles converted (mma_tf32.cuh's note), so
// their global bytes halve and the score's chain runs on bf16-exact
// values: the JAX kernel's bf16 dot with an f32 accumulator, up to the
// order of the sum. P is rounded to bf16 where the JAX kernel casts it,
// P·V is one TF32 product of bf16-exact operands (`mma1`), and outh is
// rounded once to bf16; m, se and su stay float, from the unrounded e.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "graphit_tile.cuh"
#include "mma_tf32.cuh"
#include "strips.cuh"

namespace fwd {

using namespace strips;

// a ring stage: the key tile and its values (a chunk of at most 64
// columns)
template <int kW>
__host__ __device__ inline int stage_floats(Shape sh) {
  return key_floats<kW>(sh) + vw_floats<kMaxW>(sh);
}

template <int kW>
__host__ __device__ inline size_t smem_floats(Shape sh) {
  return (size_t)sh.S * kStrip * ld(kW) + 2 * (size_t)stage_floats<kW>(sh);
}

// kW: the widest rows of xa and x (strips.cuh), kMaxW or (unfolded)
// kWideW; TV, TM: the types of xa, x, vw, outh and of pe, deg (float, or
// bf16: the note on bf16 operands above)
template <bool kFold, int kW, class TV = float, class TM = float>
__global__ void __launch_bounds__(kFold ? 64 * kMaxHeads : 256,
                                  kFold ? 1 : 2)
fwd_kernel(graphit::OperandsT<TV, TM> op, TV* __restrict__ outh,
           float* __restrict__ m_out, float* __restrict__ se_out,
           float* __restrict__ su_out, int H, int N, int D, int DV,
           float inv_sqrt) {
  static_assert(kW == kMaxW || (!kFold && kW == kWideW), "row width");
  constexpr int kLDX = ld(kW);
  constexpr bool kChunked = kW > kMaxW;
  constexpr bool kBf = tc::is_bf16<TV>();
  extern __shared__ float smem[];
  const Shape sh = shape(kFold, H);
  const int stage = stage_floats<kW>(sh);
  float* xas = smem;                         // [16 S][kLDX] the strips' xa
  float* ring = xas + sh.S * kStrip * kLDX;  // 2 x {key tile, vw}

  const Block blk = block_of<kFold, kChunked>(H, N, chunks(kW, DV));
  // the block's value columns: col0 .. col0 + DVc - 1
  const int col0 = kChunked ? blk.chunk * kChunk : 0;
  const int DVc = kChunked ? min(DV - col0, kChunk) : DV;
  const int warp = threadIdx.x / 32;
  const int g = tc::lane_g(), t = tc::lane_t();
  const int s = warp >> 1, u = warp & 1;
  const int hs = blk.head(s), qs0 = blk.first(s);
  const size_t bhs = (size_t)blk.b * H + hs;

  auto issue = [&](int k0, int st) {
    float* p = ring + st * stage;
    stage_keys<kW>(p, blk, sh, op, k0, H, N, D);
    stage_vw<kMaxW>(p + key_floats<kW>(sh), blk, sh, op, k0, H, N, DV, col0,
                    DVc);
    tc::cp_async_commit();
  };
  stage_strips<kW>(xas, blk, sh, op.xa, D, H, N, op.x);
  issue(0, 0);

  float cq[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int q = qs0 + g + 8 * e;
    cq[e] = q < N ? op.cq[bhs * N + q] : 0.f;
  }
  const float c0h = op.c0[hs];
  const int D8 = tc::round8(D), DV8 = tc::round8(DVc);

  // Rows g (+8): the running max m and the sums se, su and the output acc
  // (C fragments: rows g (+8), columns 8 j + 2 t (+1)), each in runs: a
  // tile's partial joins the open run (run = run·scale + part), and every
  // kRunTiles tiles the run joins the total, which is rescaled then, once,
  // from the max m_run of its last join (tot = tot·exp(m_run - m) + run).
  // One chain of every tile's partial, 64 a warp at N=2048, took outh
  // further from float64 than the earlier kernel's 32 (PERF.md).
  float m[2] = {-INFINITY, -INFINITY}, m_run[2] = {-INFINITY, -INFINITY};
  float se[2] = {0.f, 0.f}, su[2] = {0.f, 0.f};
  float se_tot[2] = {0.f, 0.f}, su_tot[2] = {0.f, 0.f};
  float acc[8][4] = {}, tot[8][4] = {};
  auto join = [&]() {
    float c[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      // 1 where nothing changed, or where the warp has seen no key
      c[e] = m_run[e] == m[e] ? 1.f : expf(m_run[e] - m[e]);
      se_tot[e] = fmaf(se_tot[e], c[e], se[e]);
      su_tot[e] = fmaf(su_tot[e], c[e], su[e]);
      se[e] = su[e] = 0.f;
      m_run[e] = m[e];
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        tot[j][i] = fmaf(tot[j][i], c[i >> 1], acc[j][i]);
        acc[j][i] = 0.f;
      }
  };

  const int nt = (N + kKeys - 1) / kKeys;
  for (int it = 0; it < nt; ++it) {
    const int k0 = it * kKeys;
    tc::cp_async_wait_all();
    __syncthreads();  // tile `it` visible; every warp done with it - 1
    if (it + 1 < nt) issue(k0 + kKeys, (it + 1) & 1);
    if (k0 + 16 * u >= N) continue;   // the warp's keys lie past N
    const float* xst = ring + (it & 1) * stage;
    const float* pst = xst + kKeys * kLDX + (kFold ? 0 : kStrip * s) * kLDP;
    const float* cks = xst + kKeys * kLDX + sh.P * kLDP;
    const float* dgs = cks + sh.V * kKeys;
    const float* kms = dgs + kKeys;
    const float* vws = xst + key_floats<kW>(sh) +
                       ((kFold ? s : 0) * kKeys + 16 * u) * kLD;
    if (kFold) cks += s * kKeys;

    // 1. the score, 16 queries x 16 keys
    float sc[2][4] = {};
    const float* xq = xas + (kStrip * s + g) * kLDX;
    const float* xk = xst + (16 * u + 2 * t) * kLDX;
#pragma unroll
    for (int k = 0; k < kW; k += 4) {
      if (k < D8) {
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

    // 2. the online softmax: max, rescale, e, the tile's sums, P
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kl = 16 * u + 8 * n + 2 * t + (i & 1);
        sc[n][i] = k0 + kl < N ? graphit::score(sc[n][i], cq[i >> 1],
                                                cks[kl], c0h, inv_sqrt,
                                                kms[kl])
                               : -INFINITY;
        mx[i >> 1] = fmaxf(mx[i >> 1], sc[n][i]);
      }
    float scale[2], es[2] = {0.f, 0.f}, ws[2] = {0.f, 0.f};
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      mx[e] = fmaxf(mx[e], __shfl_xor_sync(0xffffffffu, mx[e], 1));
      mx[e] = fmaxf(mx[e], __shfl_xor_sync(0xffffffffu, mx[e], 2));
      const float m_new = fmaxf(m[e], mx[e]);
      scale[e] = expf(m[e] - m_new);   // 0 on the warp's first tile
      m[e] = m_new;
    }
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kl = 16 * u + 8 * n + 2 * t;
        const float2 pe2 = op.pe ? *reinterpret_cast<const float2*>(
                                       pst + (g + 8 * e) * kLDP + kl)
                                 : make_float2(1.f, 1.f);
#pragma unroll
        for (int f = 0; f < 2; ++f) {
          const int i = 2 * e + f;
          const float ex = expf(sc[n][i] - m[e]);
          const float w = ex * ((f ? pe2.y : pe2.x) *
                                (op.deg ? dgs[kl + f] : 1.f));
          es[e] += ex;
          ws[e] += w;
          // P, rounded to bf16 where the values are (JAX's cast of P
          // to vw's dtype before P·V)
          sc[n][i] = kBf ? tc::round_bf16(w * kms[kl + f]) : w * kms[kl + f];
        }
      }
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      es[e] += __shfl_xor_sync(0xffffffffu, es[e], 1);
      es[e] += __shfl_xor_sync(0xffffffffu, es[e], 2);
      ws[e] += __shfl_xor_sync(0xffffffffu, ws[e], 1);
      ws[e] += __shfl_xor_sync(0xffffffffu, ws[e], 2);
      se[e] = fmaf(se[e], scale[e], es[e]);
      su[e] = fmaf(su[e], scale[e], ws[e]);
    }

    // 3. P·V over the warp's 16 keys, each column tile into a fresh
    // partial (its first k-step's fragment, the second added to it)
    const tc::FragA p0 = tc::frag_a_from_c(sc[0]);
    const tc::FragA p1 = tc::frag_a_from_c(sc[1]);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (8 * j < DV8) {
        float part[4];
        tc::mma_set<kBf>(part, p0, tc::load_b_kn_pairs(vws, kLD, 0, 8 * j));
        tc::mma_add<kBf>(part, p1, tc::load_b_kn_pairs(vws, kLD, 8, 8 * j));
#pragma unroll
        for (int i = 0; i < 4; ++i)
          acc[j][i] = fmaf(acc[j][i], scale[i >> 1], part[i]);
      }
    if (it % graphit::kRunTiles == graphit::kRunTiles - 1) join();
  }
  join();   // the open run

  // the strip's two warps: warp u = 1 hands its totals to warp u = 0
  // through the strip's xa rows, [16][kLDX]: the output in columns 0..63,
  // then m, se, su
  __syncthreads();  // every warp done with the xa rows
  float* mrg = xas + kStrip * s * kLDX;
  if (u == 1) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        mrg[(g + 8 * (i >> 1)) * kLDX + 8 * j + 2 * t + (i & 1)] = tot[j][i];
    if (t == 0)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float* r = mrg + (g + 8 * e) * kLDX + kMaxW;
        r[0] = m[e];
        r[1] = se_tot[e];
        r[2] = su_tot[e];
      }
  }
  __syncthreads();
  if (u == 1) return;
  float a0[2], a1[2], div[2], qm[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const float* r = mrg + (g + 8 * e) * kLDX + kMaxW;
    const float m_all = fmaxf(m[e], r[0]);
    a0[e] = expf(m[e] - m_all);
    a1[e] = expf(r[0] - m_all);      // 0 where warp 1 saw no key
    const float se_all = fmaf(se_tot[e], a0[e], r[1] * a1[e]);
    const float su_all = fmaf(su_tot[e], a0[e], r[2] * a1[e]);
    div[e] = fabsf(su_all / se_all) > graphit::kEps ? su_all : se_all;
    const int q = qs0 + g + 8 * e;
    qm[e] = q < N ? op.mask[(size_t)blk.b * N + q] : 0.f;
    if (q < N && t == 0 && blk.chunk == 0) {
      m_out[bhs * N + q] = m_all;
      se_out[bhs * N + q] = se_all;
      su_out[bhs * N + q] = su_all;
    }
  }
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int e = i >> 1, q = qs0 + g + 8 * e;
      const int col = 8 * j + 2 * t + (i & 1);
      if (q < N && col < DVc) {
        const float a = fmaf(tot[j][i], a0[e],
                             mrg[(g + 8 * e) * kLDX + col] * a1[e]);
        tc::store(outh + (bhs * N + q) * DV + col0 + col, a / div[e] * qm[e]);
      }
    }
}

// Launch either grid at row width kW: blocks of 2 S warps, times the
// chunks of the value columns, dynamic shared memory set first.
template <bool kFold, int kW = kMaxW, class TV = float, class TM = float>
int launch(graphit::OperandsT<TV, TM> op, TV* outh, float* m, float* se,
           float* su, int B, int H, int N, int D, int DV, float inv_sqrt,
           cudaStream_t stream) {
  const Shape sh = shape(kFold, H);
  const size_t smem = sizeof(float) * smem_floats<kW>(sh);
  cudaError_t err = cudaFuncSetAttribute(
      fwd_kernel<kFold, kW, TV, TM>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  fwd_kernel<kFold, kW, TV, TM>
      <<<blocks(kFold, B, H, N, chunks(kW, DV)), 64 * sh.S, smem, stream>>>(
          op, outh, m, se, su, H, N, D, DV, inv_sqrt);
  return (int)cudaGetLastError();
}

}  // namespace fwd
