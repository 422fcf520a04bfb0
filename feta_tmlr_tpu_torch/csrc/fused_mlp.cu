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
// Widths: din and dout are zero-padded to D, the bucket 8/16/32/64 of
// max(din, dout) (a template parameter), so any width up to 64 runs; F is
// any size and R may be ragged (rows >= R load zeros and store nothing).
//
// Forward (`fwd_kernel<D, kDrop>`), one pass on the tensor cores with the
// weights resident; kDrop is rate > 0. Rows lie on the mma's M; per 16
// rows and 8 hidden units (a k-step):
//   pre = b1 + x W1: m16n8k8 with x as A (K = din; its fragments loaded
//     once a strip) and W1 as B;
//   h = relu(pre), or 0 where the keep bit drops the unit, in the C
//     fragment's registers, once per (row, unit) (`Dropout::keep_p`: the
//     bits of keep_scale with mix32's first step taken apart, rk ^ (rk >>
//     16) once a row and j ^ (j >> 16) once a unit: 2 instructions fewer a
//     hash); 1 / (1 - rate) is taken once on each y, at the group's sum;
//   y += h W2 (K = the 8 units, N = dout): A straight from pre's C
//     fragment (frag_a_from_c's order), no trip through shared memory.
// Both products in 3xTF32, a fresh fragment per product added on the CUDA
// cores, the independent products of a k-step issued together (`fresh3`);
// the weights and h are split by `split_t`, lo not rounded. One block of
// 16 warps an SM stages a slab of U = 16384 / D hidden units once (2048 at
// D = 8: the SAN head's whole F), W1 and W2 as the m16n8k8 B fragments (a
// float4 a lane and k-step, 128 KB) and b1, then keeps them while its four
// groups of four warps (a warp on each SM sub-partition) walk their rows
// in strips of 32 (16 at D >= 32), each weight fragment split once for a
// strip's two m-tiles. Warp w of a group takes the w-th quarter of the
// slab's k-steps; its y runs as a fresh fragment per k-step into a run of
// kRunTerms k-steps, each run into the lane's total in shared memory, and
// the group adds its four warps' totals in warp order behind a named
// barrier. The grid is persistent: per slab a block an SM, each group a
// contiguous run of whole m-tiles (80 rows at R = 40,960), so there is no
// tail wave. With more than one slab (F > U) each slab writes a partial of
// R·dout and `fwd_finish_kernel` adds them in slab order, in runs, with b2
// (a second launch). No float atomics: y is bit-identical run to run.
//
// What bounds the forward on the H100 at R = 40,960, din = dout = 8, F =
// 2048: its two products are 2.68 GFLOP, 0.016 ms in 3xTF32 at the TF32
// peak; the keep bit's 84 M hashes take 0.035 ms of the INT32 lanes at
// keep_p's 7 instructions (2 IMAD beside them). What it issues is bound by
// mma.sync: 6 m16n8k8 a 16 x 8 tile, 3.93 M in all, about 17 cycles each
// of an SM sub-partition, ~0.065 ms. Measured (kernel_ab.py --mlp, PERF.md):
// 0.107 ms at rate 0.1 and 0.075 at rate 0 (the SIMT kernel it replaced:
// 0.157 and 0.104; its second wave held 56 of 320 blocks). Of that, the
// launch with 155 KB of shared memory takes 0.005 ms and the staging 0.007
// (every block reads the same 136 KB from L2), and the rest is close to
// the sum of the mma.sync time and the other instructions', not their
// maximum: the keep bit adds its 0.033 ms at rate 0.1, and fewer
// instructions of any kind helped where reordering them did not. Slower,
// on the same card: the
// splits on the FP32 pipe, the weights staged in their own layout by
// 16-byte copies, x W1 of step j + 1 issued with h W2 of step j, m-tile 0's
// act issued during m-tile 1's products, 24 warps a block, one m-tile a
// strip, x W1 as an FMA chain (6 mma.sync fewer, 64 FFMA more: 24 %
// slower), the staging in four phases with the first strip waiting per
// phase (19 % slower). wgmma's TF32 tile would lower the mma.sync floor.
//
// Backward (`bwd_kernel<D>`), one pass on the tensor cores, then
// `finish_kernel`. The grid is (slab of U hidden units, split of rows); U =
// 256 at D = 8 (two 16-unit m-tiles a warp), else 128. Each block holds
// its slab's W1, W2 and b1 in shared memory while it walks its split's
// rows in tiles of 32 (16 at D >= 32), which cp.async stages into a
// two-stage ring (x and g rows, stride D + 4). The units lie on the mma's
// M and the rows on its N ("transposed"), so that every product has a K
// or an N of the width, which m16n8k8's k = n = 8 fits:
//   pre^T = W1^T x^T + b1 and dhd^T = W2 g^T (K = din, dout): the weights
//     are the A operand, the same for every row: at D = 8 they are split
//     into TF32 hi and lo once per block and kept in registers;
//   relu, the keep bit (one hash per (row, unit)), hd = relu(pre) * scale
//     and dh = (pre > 0) dhd * scale in the C fragments' registers: pre,
//     g W2^T and the keep bit are computed once per (row, unit), where the
//     earlier kernel's two layouts computed them twice (7 products for 5);
//   dW1^T += dh^T x and dW2 += hd^T g (K = 8 rows per k-step): the A
//     operands straight from the C fragments (mma_tf32.cuh's
//     frag_a_from_c, as the forward attention's P·V), no transpose;
//   db1 as the fragments' row sums; db2 as a column sum of g by slab 0;
//   dx = dh W1^T, which does not fit the orientation: each warp writes its
//     dh tile [16 rows][its units] to its own shared memory, and takes its
//     units' share of dx on the tensor cores (M = 16 rows, K = its units,
//     N = din); the eight warps' shares are added in warp order after a
//     barrier, one partial per slab, [n_slabs, R, din].
// Every product is 3xTF32 (mma_tf32.cuh: lo·hi + hi·lo + hi·hi, float32
// accuracy) with a fresh fragment per k-step added on the CUDA cores. The
// sums over rows are taken in a fixed order: dW's each 8-row k-step's
// fragment into a run of 64 rows, each run into the block's total (kept in
// shared memory); db1's and db2's a fresh partial per tile (a thread's
// rows in order), the tiles in runs of 8, each run into the total; one
// total per split. `finish_kernel` then adds the splits' weight gradients
// and the slabs' dx partials in index order in runs of 8 (db1 summed in
// runs of 2 tiles and then in one chain over 32 splits read 2.2x the CPU
// float32 route's error from float64 at R = 40,960). No
// float atomics anywhere: the gradients are bit-identical from run to run
// on one card. Two launches per call.
//
// What bounds the backward on the H100 at R = 40,960, din = dout = 8,
// F = 2048: its five products are 6.71 GFLOP, 0.100 ms as f32 FMAs at
// 67 TFLOP/s. What it issues is bound by mma.sync: each f32 product is
// three m16n8k8 TF32 products, about 15 cycles of an SM sub-partition
// each (flash_bwd.cu's note), so the four products with K or N of the
// width, 7.86 M mma.sync, take 0.112 ms, and dx's share 1.97 M more
// (0.140 ms in all); beside them the keep bit's 84 M hashes
// (`Dropout::keep_scale`: 2 IMAD on the FMA pipe and 9 instructions on
// the 64 INT32 lanes an SM, 4 LOP3, 3 SHF, ISETP and FSEL in its SASS,
// kernel_ab.py --mlp --check) take 0.045 ms of the INT32 lanes. Its
// bytes (the dx and split partials included) take about 0.01 ms.
// wgmma's TF32 m64nNk8 tile would lower the tensor-core floor about 4x.
// Measured on the H100 (kernel_ab.py --mlp): about 0.28 ms at rate 0.1,
// 0.22 at rate 0 (the three launches before, 0.45 and 0.31). What holds
// it is issue: beside 60 mma.sync a warp per 16 rows it issues the
// operand splits (4 instructions a value), the hash and the elementwise
// step, and each 3xTF32 product is three dependent mma.sync. So the
// independent products of an n-tile are issued step by step together
// (`mma3_4`: pre and g W2^T of both m-tiles, then dW1 and dW2 of both;
// `mma3_2` for dx's k-steps), the same bits, 0.31 -> 0.28 ms. Slower, on
// the same card: dx as CUDA-core FMAs joined by shuffles (1.34x), one or
// four m-tiles a warp, 64-row tiles, g W2^T as an FMA chain, a
// double-buffered dx with one barrier a tile. Registers (`-Xptxas -v`):
// bwd_kernel<8> 128 and <16> 120, no spill; <32> and <64> 128 with 496
// and 2372 bytes of spill (one m-tile a warp, the weights loaded per use).
//
// C interface (ctypes): pointers and the stream as void*, returns the
// cudaError_t of the launches.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_tf32.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

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
  // scale of hidden unit j in the row whose key is rk, with dropout on
  __device__ __forceinline__ float keep_scale(uint32_t rk, int j) const {
    return mix32(rk ^ (uint32_t)j) < threshold ? inv_keep : 0.f;
  }
  // keep_scale(rk, j) != 0 from rkp = rk ^ (rk >> 16) of the row and jp =
  // j ^ (j >> 16) of the unit: mix32's first step of rk ^ j is rkp ^ jp
  __device__ __forceinline__ bool keep_p(uint32_t rkp, uint32_t jp) const {
    uint32_t v = (rkp ^ jp) * 0x7feb352dU;
    v ^= v >> 15;
    v *= 0x846ca68bU;
    v ^= v >> 16;
    return v < threshold;
  }
  __device__ __forceinline__ float scale(uint32_t rk, int j) const {
    return on ? keep_scale(rk, j) : 1.f;
  }
};

int width_bucket(int din, int dout) {
  const int d = din > dout ? din : dout;
  if (d <= 0) return 0;
  if (d <= 8) return 8;
  if (d <= 16) return 16;
  if (d <= 32) return 32;
  if (d <= 64) return 64;
  return 0;
}

Dropout make_dropout(int on, unsigned seed, unsigned threshold,
                     float inv_keep) {
  return Dropout{on, mix32((uint32_t)seed ^ 0x9e3779b9U), threshold,
                 inv_keep};
}

// ------------------------------------------------------------- backward

// Two products in 3xTF32, their tensor-core steps interleaved so that one
// product's step issues while the other's is in flight (mma3's three are
// dependent, and the asm is volatile, so the compiler keeps this order):
// each result is mma3's, added to d0 and then to d1 (which may be the
// same accumulator).
__device__ __forceinline__ void mma3_2(float (&d0)[4], const tc::FragA& a0,
                                       const tc::FragB& b0, float (&d1)[4],
                                       const tc::FragA& a1,
                                       const tc::FragB& b1) {
  float p0[4], p1[4];
  tc::mma_fresh(p0, a0.lo, b0.hi);
  tc::mma_fresh(p1, a1.lo, b1.hi);
  tc::mma(p0, a0.hi, b0.lo);
  tc::mma(p1, a1.hi, b1.lo);
  tc::mma(p0, a0.hi, b0.hi);
  tc::mma(p1, a1.hi, b1.hi);
#pragma unroll
  for (int i = 0; i < 4; ++i) d0[i] += p0[i];
#pragma unroll
  for (int i = 0; i < 4; ++i) d1[i] += p1[i];
}

// The same for four products.
__device__ __forceinline__ void mma3_4(
    float (&d0)[4], const tc::FragA& a0, const tc::FragB& b0,
    float (&d1)[4], const tc::FragA& a1, const tc::FragB& b1,
    float (&d2)[4], const tc::FragA& a2, const tc::FragB& b2,
    float (&d3)[4], const tc::FragA& a3, const tc::FragB& b3) {
  float p0[4], p1[4], p2[4], p3[4];
  tc::mma_fresh(p0, a0.lo, b0.hi);
  tc::mma_fresh(p1, a1.lo, b1.hi);
  tc::mma_fresh(p2, a2.lo, b2.hi);
  tc::mma_fresh(p3, a3.lo, b3.hi);
  tc::mma(p0, a0.hi, b0.lo);
  tc::mma(p1, a1.hi, b1.lo);
  tc::mma(p2, a2.hi, b2.lo);
  tc::mma(p3, a3.hi, b3.lo);
  tc::mma(p0, a0.hi, b0.hi);
  tc::mma(p1, a1.hi, b1.hi);
  tc::mma(p2, a2.hi, b2.hi);
  tc::mma(p3, a3.hi, b3.hi);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    d0[i] += p0[i];
    d1[i] += p1[i];
    d2[i] += p2[i];
    d3[i] += p3[i];
  }
}

constexpr int kRunRows = 64;   // rows per run of the dW sums over rows
constexpr int kRunTerms = 8;  // terms per run: db1, db2 tiles; splits, slabs

template <int D>
struct Bwd {
  static constexpr int MT = D == 8 ? 2 : 1;     // 16-unit m-tiles a warp
  static constexpr int U = kWarps * 16 * MT;    // units of a slab
  static constexpr int KT = D / 8;              // k-steps (n-tiles) of a width
  static constexpr bool kRegW = D == 8;         // weight fragments in registers
  static constexpr int RT = D <= 16 ? 32 : 16;  // rows per tile
  static constexpr int kRun = kRunRows / RT;    // tiles per run
  static constexpr int LDX = D + 4;             // x, g and W2 rows
  static constexpr int LDW = U + 8;             // W1 rows [din][U]
  static constexpr int LDH = 16 * MT + 4;       // a warp's dh [16][LDH]
  // a thread's totals: dW1^T and dW2 C fragments, db1 of its two units
  static constexpr int kTot = 2 * MT * KT * 4 + 2 * MT;
  static constexpr size_t smem_floats() {
    return (size_t)D * LDW + U * LDX + U + 2 * 2 * RT * LDX +
           kWarps * 16 * LDH + kWarps * RT * LDX + kThreads * kTot;
  }
};

// One (slab, split) of the backward: the split's dx partial of the slab
// and its weight-gradient partial, part[split] = [dW1 din·F | db1 F |
// dW2 F·dout | db2 dout] (the slab's units; db2 by slab 0).
template <int D>
__global__ void __launch_bounds__(kThreads, 2)
bwd_kernel(const float* __restrict__ x, const float* __restrict__ w1,
           const float* __restrict__ b1, const float* __restrict__ w2,
           const float* __restrict__ g, float* __restrict__ part,
           float* __restrict__ dx_part, int R, int din, int F, int dout,
           int rows_per_split, Dropout drop) {
  using C = Bwd<D>;
  constexpr int MT = C::MT, KT = C::KT, U = C::U, RT = C::RT;
  constexpr int LDX = C::LDX, LDW = C::LDW, LDH = C::LDH;
  extern __shared__ float smem[];
  float* w1s = smem;                        // [D][LDW]  W1[k, j0 + u]
  float* w2s = w1s + D * LDW;               // [U][LDX]  W2[j0 + u, o]
  float* b1s = w2s + U * LDX;               // [U]
  float* ring = b1s + U;                    // 2 x {x [RT][LDX], g [RT][LDX]}
  float* dhs = ring + 4 * RT * LDX;         // [kWarps][16][LDH]
  float* dxs = dhs + kWarps * 16 * LDH;     // [kWarps][RT][LDX]
  float* tots = dxs + kWarps * RT * LDX;    // [kTot][kThreads]

  const int tid = threadIdx.x, warp = tid >> 5;
  const int g8 = tc::lane_g(), t = tc::lane_t();
  const int slab = blockIdx.x, split = blockIdx.y;
  const int j0 = slab * U;                  // the slab's first unit
  const int u0 = 16 * MT * warp;            // the warp's first unit in it
  const int rbeg = split * rows_per_split;
  const int rend = min(R, rbeg + rows_per_split);
  const int ntiles = rend > rbeg ? (rend - rbeg + RT - 1) / RT : 0;
  const int din8 = tc::round8(din), dout8 = tc::round8(dout);
  float* dh_w = dhs + warp * 16 * LDH;
  float* tot = tots + tid;                  // slot s at tot[s * kThreads]

  auto issue = [&](int r0, int s) {
    float* xst = ring + s * 2 * RT * LDX;
    tc::stage_rows(xst, LDX, x, din, r0, RT, rend, 0, din, din, tid,
                   kThreads);
    tc::stage_rows(xst + RT * LDX, LDX, g, dout, r0, RT, rend, 0, dout, dout,
                   tid, kThreads);
    tc::cp_async_commit();
  };
  if (ntiles > 0) issue(rbeg, 0);
  tc::stage_rows(w1s, LDW, w1, F, 0, din8, din, j0, U, F, tid, kThreads);
  tc::stage_rows(w2s, LDX, w2, dout, j0, U, F, 0, dout, dout, tid, kThreads);
  tc::stage_rows(b1s, U, b1, 0, 0, 1, 1, j0, U, F, tid, kThreads);
  tc::cp_async_commit();
  for (int s = 0; s < C::kTot; ++s) tot[s * kThreads] = 0.f;
  tc::cp_async_wait_all();
  __syncthreads();

  // The weights' fragments: pre's A (W1^T, units x din), dhd's A (W2,
  // units x dout) and dx's B (W1 as units x din). At D = 8 split once.
  tc::FragA aw1_r[C::kRegW ? MT : 1], aw2_r[C::kRegW ? MT : 1];
  if constexpr (C::kRegW) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      aw1_r[mt] = tc::load_a_t(w1s, LDW, u0 + 16 * mt, 0);
      aw2_r[mt] = tc::load_a(w2s, LDX, u0 + 16 * mt, 0);
    }
  }
  auto aw1 = [&](int mt, int ks) {
    if constexpr (C::kRegW) return aw1_r[mt];
    else return tc::load_a_t(w1s, LDW, u0 + 16 * mt, 8 * ks);
  };
  auto aw2 = [&](int mt, int ks) {
    if constexpr (C::kRegW) return aw2_r[mt];
    else return tc::load_a(w2s, LDX, u0 + 16 * mt, 8 * ks);
  };
  float b1r[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int e = 0; e < 2; ++e) b1r[mt][e] = b1s[u0 + 16 * mt + g8 + 8 * e];

  // the runs: dW1^T [mt][n-tile of din], dW2 [mt][n-tile of dout] in
  // C-fragment order, db1 [mt][unit g, g + 8]; db2 (slab 0, tid < dout)
  float w1run[MT][KT][4] = {}, w2run[MT][KT][4] = {}, b1run[MT][2] = {};
  float b2run = 0.f, b2tot = 0.f;
  const bool has_b2 = slab == 0 && tid < dout;
  auto flush = [&]() {   // the dW runs into the totals
    int s = 0;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int c = 0; c < KT; ++c)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          tot[s++ * kThreads] += w1run[mt][c][i];
          tot[s++ * kThreads] += w2run[mt][c][i];
          w1run[mt][c][i] = w2run[mt][c][i] = 0.f;
        }
  };
  auto flush_bias = [&]() {   // the db1 and db2 runs into the totals
    int s = 2 * MT * KT * 4;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        tot[s++ * kThreads] += b1run[mt][e];
        b1run[mt][e] = 0.f;
      }
    b2tot += b2run;
    b2run = 0.f;
  };

  for (int it = 0; it < ntiles; ++it) {
    const int r0 = rbeg + it * RT;
    tc::cp_async_wait_all();
    __syncthreads();  // tile `it` visible; every warp done with it - 1
    if (it + 1 < ntiles) issue(r0 + RT, (it + 1) & 1);
    const float* xs = ring + (it & 1) * 2 * RT * LDX;
    const float* gs = xs + RT * LDX;
    float b1tile[MT][2] = {};   // db1: the tile's rows, a fresh partial

#pragma unroll 1
    for (int h16 = 0; h16 < RT; h16 += 16) {
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int n0 = h16 + 8 * q;       // the n-tile's first row
        tc::FragB bx[KT], bg[KT];
#pragma unroll
        for (int ks = 0; ks < KT; ++ks) {
          if (8 * ks < din8) bx[ks] = tc::load_b_nk(xs, LDX, n0, 8 * ks);
          if (8 * ks < dout8) bg[ks] = tc::load_b_nk(gs, LDX, n0, 8 * ks);
        }
        // dW's B operands, the n-tile's x and g rows (K = its 8 rows)
        tc::FragB px[KT], pg[KT];
#pragma unroll
        for (int c = 0; c < KT; ++c) {
          if (8 * c < din8) px[c] = tc::load_b_kn_pairs(xs, LDX, n0, 8 * c);
          if (8 * c < dout8) pg[c] = tc::load_b_kn_pairs(gs, LDX, n0, 8 * c);
        }
        uint32_t rk[2] = {0u, 0u};
        if (drop.on) {
#pragma unroll
          for (int f = 0; f < 2; ++f)
            rk[f] = drop.row_key(r0 + n0 + 2 * t + f);
        }
        // pre^T and dhd^T of units u0 + 16 mt + g (+8), rows n0 + 2t (+1);
        // independent products issued together (mma3_4 / mma3_2)
        float pre[MT][4], dhd[MT][4] = {};
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int i = 0; i < 4; ++i) pre[mt][i] = b1r[mt][i >> 1];
        if constexpr (MT == 2) {   // D = 8: one k-step
          mma3_4(pre[0], aw1(0, 0), bx[0], dhd[0], aw2(0, 0), bg[0], pre[1],
                 aw1(1, 0), bx[0], dhd[1], aw2(1, 0), bg[0]);
        } else {
#pragma unroll
          for (int ks = 0; ks < KT; ++ks) {
            if (8 * ks < din8 && 8 * ks < dout8)
              mma3_2(pre[0], aw1(0, ks), bx[ks], dhd[0], aw2(0, ks), bg[ks]);
            else if (8 * ks < din8) tc::mma3(pre[0], aw1(0, ks), bx[ks]);
            else if (8 * ks < dout8) tc::mma3(dhd[0], aw2(0, ks), bg[ks]);
          }
        }
        tc::FragA adh[MT], ahd[MT];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          float dh[4], hd[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int u = u0 + 16 * mt + g8 + 8 * (i >> 1);
            const float scale = drop.scale(rk[i & 1], j0 + u);
            hd[i] = fmaxf(pre[mt][i], 0.f) * scale;
            dh[i] = pre[mt][i] > 0.f ? dhd[mt][i] * scale : 0.f;
            b1tile[mt][i >> 1] += dh[i];
            dh_w[(8 * q + 2 * t + (i & 1)) * LDH + 16 * mt + g8 +
                 8 * (i >> 1)] = dh[i];
          }
          adh[mt] = tc::frag_a_from_c(dh);
          ahd[mt] = tc::frag_a_from_c(hd);
        }
        if constexpr (MT == 2) {
          mma3_4(w1run[0][0], adh[0], px[0], w2run[0][0], ahd[0], pg[0],
                 w1run[1][0], adh[1], px[0], w2run[1][0], ahd[1], pg[0]);
        } else {
#pragma unroll
          for (int c = 0; c < KT; ++c) {
            if (8 * c < din8 && 8 * c < dout8)
              mma3_2(w1run[0][c], adh[0], px[c], w2run[0][c], ahd[0], pg[c]);
            else if (8 * c < din8) tc::mma3(w1run[0][c], adh[0], px[c]);
            else if (8 * c < dout8) tc::mma3(w2run[0][c], ahd[0], pg[c]);
          }
        }
      }
      __syncwarp();  // the warp's dh of these 16 rows complete
      // the warp's share of dx for rows h16 .. h16 + 15: M = rows, K = its
      // 16 MT units, N = din, two k-steps issued together
      float dxw[KT][4] = {};
#pragma unroll
      for (int ks = 0; ks < 2 * MT; ks += 2) {
        const tc::FragA a0 = tc::load_a(dh_w, LDH, 0, 8 * ks);
        const tc::FragA a1 = tc::load_a(dh_w, LDH, 0, 8 * ks + 8);
#pragma unroll
        for (int c = 0; c < KT; ++c)
          if (8 * c < din8)
            mma3_2(dxw[c], a0, tc::load_b_nk(w1s, LDW, 8 * c, u0 + 8 * ks),
                   dxw[c], a1,
                   tc::load_b_nk(w1s, LDW, 8 * c, u0 + 8 * ks + 8));
      }
      float* dxo = dxs + (warp * RT + h16) * LDX;
#pragma unroll
      for (int c = 0; c < KT; ++c)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          dxo[(g8 + 8 * (i >> 1)) * LDX + 8 * c + 2 * t + (i & 1)] =
              dxw[c][i];
      __syncwarp();  // dh_w read before the next rows overwrite it
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int e = 0; e < 2; ++e) b1run[mt][e] += b1tile[mt][e];
    if (has_b2) {  // db2: the tile's column sum of g
      float p = 0.f;
      for (int r = 0; r < RT; ++r) p += gs[r * LDX + tid];
      b2run += p;
    }
    if (it % C::kRun == C::kRun - 1) flush();
    if (it % kRunTerms == kRunTerms - 1) flush_bias();

    __syncthreads();  // the eight warps' dx shares of the tile complete
    for (int idx = tid; idx < RT * din; idx += kThreads) {
      const int r = idx / din, c = idx - r * din, row = r0 + r;
      if (row >= rend) break;
      float v = dxs[r * LDX + c];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) v += dxs[(w * RT + r) * LDX + c];
      dx_part[((size_t)slab * R + row) * din + c] = v;
    }
  }
  flush();
  flush_bias();

  // the totals out: each thread's C fragments, db1 over the 4 lanes of a
  // unit (xor 1, then 2)
  float* out = part + (size_t)split * ((size_t)din * F + F + (size_t)F * dout +
                                       dout);
  int s = 0;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int c = 0; c < KT; ++c)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int j = j0 + u0 + 16 * mt + g8 + 8 * (i >> 1);
        const int col = 8 * c + 2 * t + (i & 1);
        const float v1 = tot[s++ * kThreads], v2 = tot[s++ * kThreads];
        if (j < F && col < din) out[(size_t)col * F + j] = v1;
        if (j < F && col < dout)
          out[(size_t)din * F + F + (size_t)j * dout + col] = v2;
      }
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float v = tot[s++ * kThreads];
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      const int j = j0 + u0 + 16 * mt + g8 + 8 * e;
      if (t == 0 && j < F) out[(size_t)din * F + j] = v;
    }
  if (has_b2) out[(size_t)din * F + F + (size_t)F * dout + tid] = b2tot;
}

// p[0] + p[stride] + ... + p[(n - 1) stride] in index order, in runs of
// kRunTerms terms, each run into the total (graphit::RunSum's order).
__device__ float run_sum(const float* __restrict__ p, size_t stride, int n) {
  float total = 0.f, run = 0.f;
  for (int i = 0; i < n; ++i) {
    run += p[(size_t)i * stride];
    if (i % kRunTerms == kRunTerms - 1) {
      total += run;
      run = 0.f;
    }
  }
  return total + run;
}

// grads[e] = the splits' part[split][e] added in split order, in runs
// (e < E); dx[i] = the slabs' dx_part[slab][i] added so in slab order.
__global__ void finish_kernel(const float* __restrict__ part,
                              float* __restrict__ grads, int E, int n_splits,
                              const float* __restrict__ dx_part,
                              float* __restrict__ dx, size_t RD,
                              int n_slabs) {
  const size_t total = (size_t)E + RD;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    if (i < (size_t)E)
      grads[i] = run_sum(part + i, E, n_splits);
    else
      dx[i - E] = run_sum(dx_part + (i - E), RD, n_slabs);
  }
}

// -------------------------------------------------------------- forward

constexpr int kFwdThreads = 512;   // 16 warps: one block an SM, all of it
constexpr int kFwdWarps = kFwdThreads / 32;
constexpr int kGroupWarps = 4;     // a group: a warp on each sub-partition
constexpr int kGroups = kFwdWarps / kGroupWarps;
constexpr int kSlabFloats = 32768;  // a slab's W1 and W2 fragments: 128 KB

template <int D>
struct Fwd {
  static constexpr int MT = D <= 16 ? 2 : 1;  // 16-row m-tiles a strip
  static constexpr int KT = D / 8;     // k-steps of din, n-tiles of dout
  static constexpr int U = kSlabFloats / (2 * D);   // units of a slab
  static constexpr int kSlots = MT * KT * 4;  // a lane's y of a strip
};

// The forward's shared memory for F hidden units: the slab's fragments, b1
// and every lane's y totals.
template <int D>
size_t fwd_smem(int F) {
  const int ks = (F < Fwd<D>::U ? (F + 7) / 8 : Fwd<D>::U / 8);
  return sizeof(float) * ((size_t)ks * (Fwd<D>::KT * 128 + 8) +
                           (size_t)kFwdThreads * Fwd<D>::kSlots);
}

// tc::split without lo's rounding, one instruction fewer: the tensor cores
// drop lo's 13 low bits, about 2^-22 of x at most
__device__ __forceinline__ tc::Split split_t(float x) {
  const uint32_t hi = __float_as_uint(x) + 0x1000u;
  return tc::Split{
      hi, __float_as_uint(x - __uint_as_float(hi & 0xffffe000u))};
}

// p[i] = a(i)·b(i) for i < N, each in 3xTF32 into a fresh fragment, the N
// products' tensor-core steps interleaved (mma3's three are dependent).
template <int N, class FA, class FB>
__device__ __forceinline__ void fresh3(float (&p)[N][4], FA a, FB b) {
#pragma unroll
  for (int i = 0; i < N; ++i) tc::mma_fresh(p[i], a(i).lo, b(i).hi);
#pragma unroll
  for (int i = 0; i < N; ++i) tc::mma(p[i], a(i).hi, b(i).lo);
#pragma unroll
  for (int i = 0; i < N; ++i) tc::mma(p[i], a(i).hi, b(i).hi);
}

// One strip of a warp: MA m-tiles of 16 rows from r0, over the slab's
// k-steps [kb, ke) of 8 hidden units; y into the lane's totals `tot` (slot
// s at tot[32 s]) in runs of kRunTerms k-steps.
template <int D, int MA, bool kDrop>
__device__ __forceinline__ void fwd_strip(
    const float* __restrict__ x, const float* pack, const float* b1s,
    float* tot, int r0, int R, int din, int kb, int ke, int j0,
    const Dropout& drop) {
  using C = Fwd<D>;
  constexpr int KT = C::KT, N = MA * KT;
  const int g8 = tc::lane_g(), t = tc::lane_t(), lane = threadIdx.x & 31;
  // x's A fragments, rows r0 + 16 m + g (+ 8), columns 8 c + t (+ 4)
  tc::FragA ax[MA][KT];
  uint32_t rk[MA][2];
#pragma unroll
  for (int m = 0; m < MA; ++m) {
    const int ra = r0 + 16 * m + g8, rb = ra + 8;
#pragma unroll
    for (int c = 0; c < KT; ++c) {
      const int ca = 8 * c + t, cb = ca + 4;
      auto ld = [&](int r, int k) {
        return r < R && k < din ? __ldg(x + (size_t)r * din + k) : 0.f;
      };
      const float v[4] = {ld(ra, ca), ld(rb, ca), ld(ra, cb), ld(rb, cb)};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const tc::Split sp = tc::split(v[i]);
        ax[m][c].hi[i] = sp.hi;
        ax[m][c].lo[i] = sp.lo;
      }
    }
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      rk[m][e] = kDrop ? drop.row_key(ra + 8 * e) : 0u;
      rk[m][e] ^= rk[m][e] >> 16;
    }
  }
  float yrun[MA][KT][4] = {};
  auto flush = [&]() {
#pragma unroll
    for (int m = 0; m < MA; ++m)
#pragma unroll
      for (int c = 0; c < KT; ++c)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          tot[32 * ((m * KT + c) * 4 + i)] += yrun[m][c][i];
          yrun[m][c][i] = 0.f;
        }
  };
#pragma unroll 1
  for (int ks = kb; ks < ke; ++ks) {
    // W1's B of din k-step c and W2's B of dout n-tile c, split once for
    // the MA m-tiles; b1 of units 2t, 2t + 1 (the C fragment's columns)
    const float* pk = pack + (size_t)ks * KT * 128 + 4 * lane;
    tc::FragB bw1[KT], bw2[KT];
#pragma unroll
    for (int c = 0; c < KT; ++c) {
      const float4 w = *reinterpret_cast<const float4*>(pk + 128 * c);
      const tc::Split s0 = split_t(w.x), s1 = split_t(w.y);
      const tc::Split s2 = split_t(w.z), s3 = split_t(w.w);
      bw1[c] = tc::FragB{{s0.hi, s1.hi}, {s0.lo, s1.lo}};
      bw2[c] = tc::FragB{{s2.hi, s3.hi}, {s2.lo, s3.lo}};
    }
    const float2 bb = *reinterpret_cast<const float2*>(b1s + 8 * ks + 2 * t);
    // pre = b1 + x W1: a fresh fragment per din k-step, added in order
    float p[N][4];
    fresh3<N>(p, [&](int i) -> const tc::FragA& { return ax[i / KT][i % KT]; },
              [&](int i) -> const tc::FragB& { return bw1[i % KT]; });
    uint32_t jp[2];
#pragma unroll
    for (int f = 0; f < 2; ++f) {
      const uint32_t j = j0 + 8 * ks + 2 * t + f;
      jp[f] = j ^ (j >> 16);
    }
    tc::FragA ah[MA];
#pragma unroll
    for (int m = 0; m < MA; ++m) {
      float h[4] = {bb.x, bb.y, bb.x, bb.y};
#pragma unroll
      for (int c = 0; c < KT; ++c)
#pragma unroll
        for (int i = 0; i < 4; ++i) h[i] += p[m * KT + c][i];
      // h = relu(pre) * scale at the fragment's (row, unit), once each
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        h[i] = fmaxf(h[i], 0.f);
        if (kDrop && !drop.keep_p(rk[m][i >> 1], jp[i & 1])) h[i] = 0.f;
      }
      // frag_a_from_c with split_t
      const float v[4] = {h[0], h[2], h[1], h[3]};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const tc::Split sp = split_t(v[i]);
        ah[m].hi[i] = sp.hi;
        ah[m].lo[i] = sp.lo;
      }
    }
    // y += h W2 (K = the k-step's 8 units), a fresh fragment per n-tile
    fresh3<N>(p, [&](int i) -> const tc::FragA& { return ah[i / KT]; },
              [&](int i) -> const tc::FragB& { return bw2[i % KT]; });
#pragma unroll
    for (int m = 0; m < MA; ++m)
#pragma unroll
      for (int c = 0; c < KT; ++c)
#pragma unroll
        for (int i = 0; i < 4; ++i) yrun[m][c][i] += p[m * KT + c][i];
    if ((ks - kb) % kRunTerms == kRunTerms - 1) flush();
  }
  flush();
}

// y = dropout(relu(x W1 + b1)) W2 + b2 for the slab blockIdx.x of U hidden
// units: the block stages the slab's W1, W2 (as m16n8k8 B fragments, a
// float4 a lane and k-step) and b1 once and keeps them; each of its four
// groups of four warps walks its rows_per_group rows in strips of 16 MT
// rows, warp w of a group taking the w-th quarter of the slab's k-steps,
// and the group adds its four warps' y in warp order. One slab: y + b2
// into y; more: the slab's partial into y_part[slab] (fwd_finish_kernel).
template <int D, bool kDrop>
__global__ void __launch_bounds__(kFwdThreads, 1)
fwd_kernel(const float* __restrict__ x, const float* __restrict__ w1,
           const float* __restrict__ b1, const float* __restrict__ w2,
           const float* __restrict__ b2, float* __restrict__ y,
           float* __restrict__ y_part, int R, int din, int F, int dout,
           int rows_per_group, Dropout drop) {
  using C = Fwd<D>;
  constexpr int KT = C::KT, MT = C::MT, S = C::kSlots;
  extern __shared__ float smem[];
  const int slab = blockIdx.x, j0 = slab * C::U;
  const int nka = F < C::U ? (F + 7) / 8 : C::U / 8;   // k-steps allocated
  const int nks = (min(C::U, F - j0) + 7) / 8;          // the slab's
  float* pack = smem;                       // [nka][KT][32 lanes][4]
  float* b1s = pack + (size_t)nka * KT * 128;   // [8 nka]
  float* tots = b1s + 8 * nka;              // [kFwdWarps][S][32 lanes]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // the slab's fragments: lane 4g + t of k-step ks, tile c holds W1[8c + t]
  // [u + g], W1[8c + t + 4][u + g], W2[u + 2t][8c + g], W2[u + 2t + 1][8c
  // + g] with u = j0 + 8 ks; zero beyond din, dout and F. A warp copies one
  // of the four for its 32 lanes: 4 rows of 32 contiguous bytes
  for (int e = tid; e < nks * KT * 128; e += kFwdThreads) {
    const int l = e & 31, q = (e >> 5) & 3, kc = e >> 7;
    const int ks = kc / KT, c = kc - ks * KT;
    const int g = l >> 2, t = l & 3, u = j0 + 8 * ks;
    const float* src;
    bool valid;
    if (q < 2) {
      const int k = 8 * c + t + 4 * q, j = u + g;
      valid = k < din && j < F;
      src = w1 + (size_t)k * F + j;
    } else {
      const int j = u + 2 * t + q - 2, o = 8 * c + g;
      valid = j < F && o < dout;
      src = w2 + (size_t)j * dout + o;
    }
    tc::cp_async4(pack + 128 * kc + 4 * l + q, valid ? src : w1, valid);
  }
  for (int j = tid; j < 8 * nks; j += kFwdThreads)
    tc::cp_async4(b1s + j, j0 + j < F ? b1 + j0 + j : b1, j0 + j < F);
  tc::cp_async_commit();
  for (int s = tid; s < kFwdWarps * S * 32; s += kFwdThreads) tots[s] = 0.f;
  tc::cp_async_wait_all();
  __syncthreads();

  const int group = warp / kGroupWarps, gw = warp % kGroupWarps;
  const int rbeg = (blockIdx.y * kGroups + group) * rows_per_group;
  const int rend = min(R, rbeg + rows_per_group);
  const int kpw = (nks + kGroupWarps - 1) / kGroupWarps;
  const int kb = min(nks, gw * kpw), ke = min(nks, kb + kpw);
  float* tot = tots + warp * S * 32 + lane;
  float* gtot = tots + group * kGroupWarps * S * 32;
  const int gt = gw * 32 + lane;            // thread of the group
  for (int r0 = rbeg; r0 < rend; r0 += 16 * MT) {
    if (MT == 2 && r0 + 16 >= rend)
      fwd_strip<D, 1, kDrop>(x, pack, b1s, tot, r0, R, din, kb, ke, j0,
                             drop);
    else
      fwd_strip<D, MT, kDrop>(x, pack, b1s, tot, r0, R, din, kb, ke, j0,
                              drop);
    // the group's four warps' y added in warp order; the totals zeroed
    asm volatile("bar.sync %0, %1;" ::"r"(1 + group),
                 "n"(kGroupWarps * 32) : "memory");
    for (int e = gt; e < S * 32; e += kGroupWarps * 32) {
      const int s = e >> 5, l = e & 31, m = s / (KT * 4);
      const int c = (s >> 2) % KT, i = s & 3;
      const int row = r0 + 16 * m + (l >> 2) + 8 * (i >> 1);
      const int col = 8 * c + 2 * (l & 3) + (i & 1);
      float* p = gtot + e;
      float v = p[0];
#pragma unroll
      for (int w = 1; w < kGroupWarps; ++w) v += p[w * S * 32];
      if (kDrop) v *= drop.inv_keep;   // h was relu(pre) or 0
#pragma unroll
      for (int w = 0; w < kGroupWarps; ++w) p[w * S * 32] = 0.f;
      if (row < rend && col < dout) {
        if (y_part)
          y_part[((size_t)slab * R + row) * dout + col] = v;
        else
          y[(size_t)row * dout + col] = v + b2[col];
      }
    }
    asm volatile("bar.sync %0, %1;" ::"r"(1 + group),
                 "n"(kGroupWarps * 32) : "memory");
  }
}

// y[r, o] = the slabs' partials added in slab order, in runs, + b2[o]
__global__ void fwd_finish_kernel(const float* __restrict__ y_part,
                                  const float* __restrict__ b2,
                                  float* __restrict__ y, size_t RD,
                                  int dout, int n_slabs) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < RD;
       i += (size_t)gridDim.x * blockDim.x)
    y[i] = run_sum(y_part + i, RD, n_slabs) + b2[i % dout];
}

int fwd_units(int D) {
  switch (D) {
    case 8: return Fwd<8>::U;
    case 16: return Fwd<16>::U;
    case 32: return Fwd<32>::U;
    default: return Fwd<64>::U;
  }
}

template <int D, bool kDrop>
cudaError_t launch_fwd(const float* x, const float* w1, const float* b1,
                       const float* w2, const float* b2, float* y,
                       float* y_part, int R, int din, int F, int dout,
                       int n_sm, Dropout drop, cudaStream_t stream) {
  const size_t smem = fwd_smem<D>(F);
  cudaError_t err = cudaFuncSetAttribute(
      fwd_kernel<D, kDrop>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const int slabs = (F + Fwd<D>::U - 1) / Fwd<D>::U;
  // a block an SM; each group's rows a whole number of m-tiles
  const int splits = (n_sm + slabs - 1) / slabs;
  const int groups = splits * kGroups;
  const int rows = ((R + groups - 1) / groups + 15) / 16 * 16;
  fwd_kernel<D, kDrop><<<dim3(slabs, splits), kFwdThreads, smem, stream>>>(
      x, w1, b1, w2, b2, y, slabs > 1 ? y_part : nullptr, R, din, F, dout,
      rows, drop);
  err = cudaGetLastError();
  if (err != cudaSuccess || slabs == 1) return err;
  const size_t RD = (size_t)R * dout;
  const size_t blocks = (RD + kThreads - 1) / kThreads;
  fwd_finish_kernel<<<blocks < 4096 ? (int)blocks : 4096, kThreads, 0,
                      stream>>>(y_part, b2, y, RD, dout, slabs);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_fwd_rate(const float* x, const float* w1, const float* b1,
                            const float* w2, const float* b2, float* y,
                            float* y_part, int R, int din, int F, int dout,
                            int n_sm, Dropout drop, cudaStream_t stream) {
  return drop.on ? launch_fwd<D, true>(x, w1, b1, w2, b2, y, y_part, R, din,
                                       F, dout, n_sm, drop, stream)
                 : launch_fwd<D, false>(x, w1, b1, w2, b2, y, y_part, R,
                                        din, F, dout, n_sm, drop, stream);
}

int bwd_units(int D) {
  switch (D) {
    case 8: return Bwd<8>::U;
    case 16: return Bwd<16>::U;
    case 32: return Bwd<32>::U;
    default: return Bwd<64>::U;
  }
}

// Rows per split: n_splits splits cover R in whole runs of kRunRows.
int rows_per_split(int R, int n_splits) {
  const int rows = (R + n_splits - 1) / n_splits;
  return (rows + kRunRows - 1) / kRunRows * kRunRows;
}

template <int D>
cudaError_t launch_bwd(const float* x, const float* w1, const float* b1,
                       const float* w2, const float* g, float* dx,
                       float* part, float* grads, float* dx_part, int R,
                       int din, int F, int dout, int n_splits, Dropout drop,
                       cudaStream_t stream) {
  const size_t smem = sizeof(float) * Bwd<D>::smem_floats();
  cudaError_t err = cudaFuncSetAttribute(
      bwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const int slabs = (F + Bwd<D>::U - 1) / Bwd<D>::U;
  bwd_kernel<D><<<dim3(slabs, n_splits), kThreads, smem, stream>>>(
      x, w1, b1, w2, g, part, dx_part, R, din, F, dout,
      rows_per_split(R, n_splits), drop);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const int E = din * F + F + F * dout + dout;
  const size_t total = (size_t)E + (size_t)R * din;
  const size_t blocks = (total + kThreads - 1) / kThreads;
  finish_kernel<<<blocks < 4096 ? (int)blocks : 4096, kThreads, 0,
                  stream>>>(part, grads, E, n_splits, dx_part, dx,
                            (size_t)R * din, slabs);
  return cudaGetLastError();
}

}  // namespace

// The backward's grid: returns the number of row splits (the wrapper
// allocates that many weight-gradient partials of din·F + F + F·dout + dout
// floats), about two blocks per SM in all, whole runs of kRunRows rows per
// split; writes the number of slabs of hidden units (that many dx partials
// of R·din floats) to *n_slabs. Both are 0 for shapes the kernel rejects.
extern "C" int feta_fused_mlp_bwd_grid(int R, int din, int F, int dout,
                                       int n_sm, int* n_slabs) {
  const int D = width_bucket(din, dout);
  *n_slabs = 0;
  if (D == 0 || F <= 0 || R <= 0 || n_sm <= 0) return 0;
  const int slabs = (F + bwd_units(D) - 1) / bwd_units(D);
  const int want = (2 * n_sm + slabs - 1) / slabs;
  const int rows = rows_per_split(R, want);
  *n_slabs = slabs;
  return (R + rows - 1) / rows;
}

// The forward's slabs of hidden units: y_part needs that many partials of
// R·dout floats where it is more than 1 (0 for shapes the kernel rejects).
extern "C" int feta_fused_mlp_fwd_slabs(int din, int F, int dout) {
  const int D = width_bucket(din, dout);
  if (D == 0 || F <= 0) return 0;
  return (F + fwd_units(D) - 1) / fwd_units(D);
}

extern "C" int feta_fused_mlp_fwd(const void* x, const void* w1,
                                  const void* b1, const void* w2,
                                  const void* b2, void* y, void* y_part,
                                  int R, int din, int F, int dout, int n_sm,
                                  int drop_on, unsigned seed,
                                  unsigned threshold, float inv_keep,
                                  void* stream) {
  const int D = width_bucket(din, dout);
  if (D == 0 || R <= 0 || F <= 0 || n_sm <= 0)
    return (int)cudaErrorInvalidValue;
  const Dropout drop = make_dropout(drop_on, seed, threshold, inv_keep);
  const auto* xf = (const float*)x;
  const auto* w1f = (const float*)w1;
  const auto* b1f = (const float*)b1;
  const auto* w2f = (const float*)w2;
  const auto* b2f = (const float*)b2;
  auto* yf = (float*)y;
  auto* pf = (float*)y_part;
  auto s = (cudaStream_t)stream;
  switch (D) {
    case 8:
      return (int)launch_fwd_rate<8>(xf, w1f, b1f, w2f, b2f, yf, pf, R,
                                    din, F, dout, n_sm, drop, s);
    case 16:
      return (int)launch_fwd_rate<16>(xf, w1f, b1f, w2f, b2f, yf, pf, R,
                                     din, F, dout, n_sm, drop, s);
    case 32:
      return (int)launch_fwd_rate<32>(xf, w1f, b1f, w2f, b2f, yf, pf, R,
                                     din, F, dout, n_sm, drop, s);
    default:
      return (int)launch_fwd_rate<64>(xf, w1f, b1f, w2f, b2f, yf, pf, R,
                                     din, F, dout, n_sm, drop, s);
  }
}

extern "C" int feta_fused_mlp_bwd(const void* x, const void* w1,
                                  const void* b1, const void* w2,
                                  const void* g, void* dx, void* part,
                                  void* grads, void* dx_part, int R, int din,
                                  int F, int dout, int n_splits, int drop_on,
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
  auto* dp = (float*)dx_part;
  auto s = (cudaStream_t)stream;
  switch (D) {
    case 8:
      return (int)launch_bwd<8>(xf, w1f, b1f, w2f, gf, dxf, pf, gr, dp, R,
                                din, F, dout, n_splits, drop, s);
    case 16:
      return (int)launch_bwd<16>(xf, w1f, b1f, w2f, gf, dxf, pf, gr, dp, R,
                                 din, F, dout, n_splits, drop, s);
    case 32:
      return (int)launch_bwd<32>(xf, w1f, b1f, w2f, gf, dxf, pf, gr, dp, R,
                                 din, F, dout, n_splits, drop, s);
    default:
      return (int)launch_bwd<64>(xf, w1f, b1f, w2f, gf, dxf, pf, gr, dp, R,
                                 din, F, dout, n_splits, drop, s);
  }
}

extern "C" const char* feta_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
