// The block geometry and the staging of the strip kernels: the backward
// query pass (bwd_q.cuh) and the forward (fwd.cuh), each one kernel body
// launched on two grids.
//
// Strips. A block owns S strips of 16 queries (the mma's M), a strip being
// one head's 16 consecutive queries, and loops over the keys in 32-key
// tiles:
//   unfolded: one block per (b, 64-query tile, h), h fastest so that the H
//     blocks reading one pe tile meet in L2; its S = 4 strips are head h's
//     queries 16 s .. 16 s + 15 of the tile;
//   folded:   one block per (b, 16-query tile) for all H <= 8 heads; strip
//     s is head s's 16 queries, and the heads share the staged x, pe, deg
//     and key mask (the TPU's reason to fold).
// Two warps a strip, warp 2 s + u, 8 warps (unfolded) or 2H (folded). A
// strip's arithmetic does not depend on the grid, so both grids give the
// same bits.
//
// Staging, by cp.async (mma_tf32.cuh): rows of up to kW floats padded to
// ld(kW) = kW + 4, columns past the width and rows past N zero-filled by
// the copy. A 32-key tile is {x [32][ld(kW)], pe [P][kLDP], ck [V][32],
// deg [32], key mask [32]} (P = 64 query rows unfolded, 16 folded; V = 1
// head unfolded, H folded), and its values vw [V][32][ld(kWV)].
//
// Widths. The folded grid and the unfolded kernels at D, DV <= 64 take
// rows of kW = kMaxW = 64 floats (kLD = 68). Wider models (d_model 128: the OGB molecular CLIs)
// take the unfolded kernels' kW = kWideW = 128 instantiation: the score's
// FMA chain runs over all D <= 128 columns in order, the same chain, and
// each block writes one kChunk-wide chunk of the output columns, a grid
// axis of chunks fastest (`Block::chunk`), every chunk recomputing the
// score (and the backward's ga) for its columns. An output entry is the
// same sum in the same order whatever the chunking.

#pragma once

#include <cuda_runtime.h>

#include "graphit_tile.cuh"
#include "mma_tf32.cuh"

namespace strips {

constexpr int kKeys = 32;          // keys per tile
constexpr int kStrip = 16;         // queries per strip
constexpr int kLD = 68;            // rows of up to 64 floats, padded
constexpr int kLDP = kKeys + 8;    // pe [query][key]: float2 reads
constexpr int kMaxW = 64;          // the folded kernels' widest rows
constexpr int kWideW = 128;        // the unfolded kernels' widest rows
constexpr int kChunk = 64;         // output columns a block (kW = kWideW)
constexpr int kUnfoldedStrips = 4;
constexpr int kMaxHeads = 8;

struct Shape {
  int S, P, V;   // strips, staged pe rows, staged vw / ck heads
};

__host__ __device__ inline Shape shape(bool fold, int H) {
  return fold ? Shape{H, kStrip, H}
              : Shape{kUnfoldedStrips, kUnfoldedStrips * kStrip, 1};
}

// padded row stride of rows of up to kW floats
__host__ __device__ constexpr int ld(int kW) { return kW + 4; }

// log2 of a row width kW (64 or 128): the staging loops take row and
// column of a flat index by shift and mask (a signed division by kW / 4
// cost the key pass at kW = 64 registers, 100 bytes of spill and 13 %)
__host__ __device__ constexpr int log2w(int kW) { return kW == 128 ? 7 : 6; }

// chunks of kChunk output columns of a width w at row width kW
__host__ __device__ inline int chunks(int kW, int w) {
  return kW > kMaxW ? (w + kChunk - 1) / kChunk : 1;
}

// floats of a key tile's x, pe, ck, deg and key mask
template <int kW>
__host__ __device__ inline int key_floats(Shape sh) {
  return kKeys * ld(kW) + sh.P * kLDP + (sh.V + 2) * kKeys;
}

// floats of a key tile's vw rows of up to kWV floats
template <int kWV>
__host__ __device__ inline int vw_floats(Shape sh) {
  return sh.V * kKeys * ld(kWV);
}

// blocks of either grid, times the chunks of the output columns
__host__ inline int blocks(bool fold, int B, int H, int N, int nc = 1) {
  const int tile = fold ? kStrip : kUnfoldedStrips * kStrip;
  return B * ((N + tile - 1) / tile) * (fold ? 1 : H) * nc;
}

// The block's graph b, first query q0, (unfolded) head hb and chunk of
// output columns; strip s's head and first query.
struct Block {
  int b, q0, hb, chunk;
  bool fold;
  __device__ int head(int s) const { return fold ? s : hb; }
  __device__ int first(int s) const { return fold ? q0 : q0 + kStrip * s; }
};

// kChunked: the grid has `nc` chunks of output columns, the fastest axis
template <bool kFold, bool kChunked = false>
__device__ __forceinline__ Block block_of(int H, int N, int nc = 1) {
  int bid = blockIdx.x, hb = 0, q0, chunk = 0;
  if (kChunked) {
    chunk = bid % nc;
    bid /= nc;
  }
  if (kFold) {
    const int nq = (N + kStrip - 1) / kStrip;
    q0 = (bid % nq) * kStrip;
    bid /= nq;
  } else {
    const int nq = (N + kUnfoldedStrips * kStrip - 1) /
                   (kUnfoldedStrips * kStrip);
    hb = bid % H;
    bid /= H;
    q0 = (bid % nq) * kUnfoldedStrips * kStrip;
    bid /= nq;
  }
  return Block{bid, q0, hb, chunk, kFold};
}

// cp.async of `rows` rows of width w <= kW into dst [rows][ld(kW)], columns
// w .. kW - 1 zero: row r from src_row(r), or all zero where that is
// nullptr. 4 elements a copy where `vec` (w and the rows' offsets multiples
// of 4 elements), chunk i at row i / (kW / 4), columns 4 (i % (kW / 4)) ..
// + 3; else one. kW is 64 or 128 (`log2w`). A bf16 source (T) is
// converted to float on the way in (mma_tf32.cuh's `copy4`).
template <int kW, class T, class Src>
__device__ __forceinline__ void stage_rows_w(float* dst, int rows, int w,
                                             bool vec, Src src_row,
                                             const T* dummy) {
  const int tid = threadIdx.x, nthreads = blockDim.x;
  constexpr int kVecs = kW / 4, kShift = log2w(kW) - 2;
  if (vec) {
    for (int i = tid; i < rows * kVecs; i += nthreads) {
      const int r = i >> kShift, c = (i & (kVecs - 1)) * 4;
      const T* p = src_row(r);
      const bool valid = p != nullptr && c < w;
      tc::copy4(dst + r * ld(kW) + c, valid ? p + c : dummy, valid);
    }
  } else {
    for (int i = tid; i < rows * kW; i += nthreads) {
      const int r = i >> log2w(kW), c = i & (kW - 1);
      const T* p = src_row(r);
      const bool valid = p != nullptr && c < w;
      tc::copy1(dst + r * ld(kW) + c, valid ? p + c : dummy, valid);
    }
  }
}

template <class T>
__device__ __forceinline__ bool vec_rows(const T* base, int w) {
  return w % 4 == 0 && reinterpret_cast<size_t>(base) % (4 * sizeof(T)) == 0;
}

// The strips' rows of a per-head operand `base` [B, H, N, w] into dst
// [16 S][ld(kW)], rows past N zero.
template <int kW, class T>
__device__ __forceinline__ void stage_strips(float* dst, const Block& blk,
                                             Shape sh, const T* base,
                                             int w, int H, int N,
                                             const T* dummy) {
  stage_rows_w<kW>(
      dst, sh.S * kStrip, w, vec_rows(base, w),
      [&](int r) -> const T* {
        const int sr = r >> 4, q = blk.first(sr) + (r & 15);
        return q < N ? base + (((size_t)blk.b * H + blk.head(sr)) * N + q) * w
                     : nullptr;
      },
      dummy);
}

// Key tile k0's x, pe, ck, deg and key mask into `st` (key_floats<kW>(sh)
// floats, laid out as the note says).
template <int kW, class TV, class TM>
__device__ __forceinline__ void stage_keys(
    float* st, const Block& blk, Shape sh,
    const graphit::OperandsT<TV, TM>& op, int k0, int H, int N, int D) {
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int b = blk.b;
  const TV* dummy = op.x;
  float* pst = st + kKeys * ld(kW);
  float* vst = pst + sh.P * kLDP;     // ck [V][32], deg [32], mask [32]
  stage_rows_w<kW>(
      st, kKeys, D, vec_rows(op.x, D),
      [&](int r) -> const TV* {
        return k0 + r < N ? op.x + ((size_t)b * N + k0 + r) * D : nullptr;
      },
      dummy);
  if (op.pe) {
    const TM* pe_b = op.pe + (size_t)b * N * N;
    if (N % 4 == 0 &&
        reinterpret_cast<size_t>(op.pe) % (4 * sizeof(TM)) == 0) {
      for (int i = tid; i < sh.P * kKeys / 4; i += nthreads) {
        const int r = i >> 3, c = (i & 7) * 4, q = blk.q0 + r;
        const bool valid = q < N && k0 + c < N;
        tc::copy4(pst + r * kLDP + c,
                  valid ? pe_b + (size_t)q * N + k0 + c : pe_b, valid);
      }
    } else {
      for (int i = tid; i < sh.P * kKeys; i += nthreads) {
        const int r = i >> 5, c = i & (kKeys - 1), q = blk.q0 + r;
        const bool valid = q < N && k0 + c < N;
        tc::copy1(pst + r * kLDP + c,
                  valid ? pe_b + (size_t)q * N + k0 + c : pe_b, valid);
      }
    }
  }
  for (int i = tid; i < (sh.V + 2) * kKeys; i += nthreads) {
    const int j = i >> 5, key = k0 + (i & (kKeys - 1));
    if (j == sh.V) {                  // deg, of the modulation's type
      const bool valid = key < N && op.deg;
      tc::copy1(vst + i, valid ? op.deg + (size_t)b * N + key
                               : reinterpret_cast<const TM*>(op.mask),
                valid);
      continue;
    }
    const float* src = j < sh.V ? op.ck + ((size_t)b * H + blk.head(j)) * N
                                : op.mask + (size_t)b * N;
    const bool valid = key < N;
    tc::cp_async4(vst + i, valid ? src + key : op.mask, valid);
  }
}

// Key tile k0's vw rows of every staged head into dst [V][32][ld(kWV)]:
// columns col0 .. col0 + w - 1 of rows of DV floats (w <= kWV).
template <int kWV, class TV, class TM>
__device__ __forceinline__ void stage_vw(float* dst, const Block& blk,
                                         Shape sh,
                                         const graphit::OperandsT<TV, TM>& op,
                                         int k0, int H, int N, int DV,
                                         int col0, int w) {
  stage_rows_w<kWV>(
      dst, sh.V * kKeys, w, vec_rows(op.vw, DV),
      [&](int r) -> const TV* {
        const int key = k0 + (r & (kKeys - 1));
        return key < N ? op.vw + (((size_t)blk.b * H + blk.head(r >> 5)) * N +
                                  key) * DV + col0
                       : nullptr;
      },
      op.x);
}

}  // namespace strips
