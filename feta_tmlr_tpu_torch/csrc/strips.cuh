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
// Staging, by cp.async (mma_tf32.cuh): rows of up to 64 floats padded to
// kLD, columns past the width and rows past N zero-filled by the copy.
// A 32-key tile is {x [32][kLD], pe [P][kLDP], ck [V][32], deg [32], key
// mask [32]} (P = 64 query rows unfolded, 16 folded; V = 1 head unfolded,
// H folded), and its values vw [V][32][kLD].

#pragma once

#include <cuda_runtime.h>

#include "graphit_tile.cuh"
#include "mma_tf32.cuh"

namespace strips {

constexpr int kKeys = 32;          // keys per tile
constexpr int kStrip = 16;         // queries per strip
constexpr int kLD = 68;            // rows of up to 64 floats, padded
constexpr int kLDP = kKeys + 8;    // pe [query][key]: float2 reads
constexpr int kMaxW = 64;
constexpr int kUnfoldedStrips = 4;
constexpr int kMaxHeads = 8;

struct Shape {
  int S, P, V;   // strips, staged pe rows, staged vw / ck heads
};

__host__ __device__ inline Shape shape(bool fold, int H) {
  return fold ? Shape{H, kStrip, H}
              : Shape{kUnfoldedStrips, kUnfoldedStrips * kStrip, 1};
}

// floats of a key tile's x, pe, ck, deg and key mask
__host__ __device__ inline int key_floats(Shape sh) {
  return kKeys * kLD + sh.P * kLDP + (sh.V + 2) * kKeys;
}

// floats of a key tile's vw rows
__host__ __device__ inline int vw_floats(Shape sh) {
  return sh.V * kKeys * kLD;
}

// blocks of either grid
__host__ inline int blocks(bool fold, int B, int H, int N) {
  const int tile = fold ? kStrip : kUnfoldedStrips * kStrip;
  return B * ((N + tile - 1) / tile) * (fold ? 1 : H);
}

// The block's graph b, first query q0 and (unfolded) head hb; strip s's
// head and first query.
struct Block {
  int b, q0, hb;
  bool fold;
  __device__ int head(int s) const { return fold ? s : hb; }
  __device__ int first(int s) const { return fold ? q0 : q0 + kStrip * s; }
};

template <bool kFold>
__device__ __forceinline__ Block block_of(int H, int N) {
  int bid = blockIdx.x, hb = 0, q0;
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
  return Block{bid, q0, hb, kFold};
}

// cp.async of `rows` rows of width w <= 64 into dst [rows][kLD], columns w
// .. 63 zero: row r from src_row(r), or all zero where that is nullptr.
// 16 bytes a copy where `vec` (w and the rows' offsets multiples of 4
// floats), chunk i at row i / 16, columns 4 (i % 16) .. + 3; else 4 bytes.
template <class Src>
__device__ __forceinline__ void stage_rows64(float* dst, int rows, int w,
                                             bool vec, Src src_row,
                                             const float* dummy) {
  const int tid = threadIdx.x, nthreads = blockDim.x;
  if (vec) {
    for (int i = tid; i < rows * 16; i += nthreads) {
      const int r = i >> 4, c = (i & 15) * 4;
      const float* p = src_row(r);
      const bool valid = p != nullptr && c < w;
      tc::cp_async16(dst + r * kLD + c, valid ? p + c : dummy, valid);
    }
  } else {
    for (int i = tid; i < rows * kMaxW; i += nthreads) {
      const int r = i >> 6, c = i & (kMaxW - 1);
      const float* p = src_row(r);
      const bool valid = p != nullptr && c < w;
      tc::cp_async4(dst + r * kLD + c, valid ? p + c : dummy, valid);
    }
  }
}

__device__ __forceinline__ bool vec_rows(const float* base, int w) {
  return w % 4 == 0 && reinterpret_cast<size_t>(base) % 16 == 0;
}

// The strips' rows of a per-head operand `base` [B, H, N, w] into dst
// [16 S][kLD], rows past N zero.
__device__ __forceinline__ void stage_strips(float* dst, const Block& blk,
                                             Shape sh, const float* base,
                                             int w, int H, int N,
                                             const float* dummy) {
  stage_rows64(
      dst, sh.S * kStrip, w, vec_rows(base, w),
      [&](int r) -> const float* {
        const int sr = r >> 4, q = blk.first(sr) + (r & 15);
        return q < N ? base + (((size_t)blk.b * H + blk.head(sr)) * N + q) * w
                     : nullptr;
      },
      dummy);
}

// Key tile k0's x, pe, ck, deg and key mask into `st` (key_floats(sh)
// floats, laid out as the note says).
__device__ __forceinline__ void stage_keys(float* st, const Block& blk,
                                           Shape sh,
                                           const graphit::Operands& op,
                                           int k0, int H, int N, int D) {
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int b = blk.b;
  const float* dummy = op.x;
  float* pst = st + kKeys * kLD;
  float* vst = pst + sh.P * kLDP;     // ck [V][32], deg [32], mask [32]
  stage_rows64(
      st, kKeys, D, vec_rows(op.x, D),
      [&](int r) -> const float* {
        return k0 + r < N ? op.x + ((size_t)b * N + k0 + r) * D : nullptr;
      },
      dummy);
  if (op.pe) {
    const float* pe_b = op.pe + (size_t)b * N * N;
    if (N % 4 == 0 && reinterpret_cast<size_t>(op.pe) % 16 == 0) {
      for (int i = tid; i < sh.P * kKeys / 4; i += nthreads) {
        const int r = i >> 3, c = (i & 7) * 4, q = blk.q0 + r;
        const bool valid = q < N && k0 + c < N;
        tc::cp_async16(pst + r * kLDP + c,
                       valid ? pe_b + (size_t)q * N + k0 + c : dummy, valid);
      }
    } else {
      for (int i = tid; i < sh.P * kKeys; i += nthreads) {
        const int r = i >> 5, c = i & (kKeys - 1), q = blk.q0 + r;
        const bool valid = q < N && k0 + c < N;
        tc::cp_async4(pst + r * kLDP + c,
                      valid ? pe_b + (size_t)q * N + k0 + c : dummy, valid);
      }
    }
  }
  for (int i = tid; i < (sh.V + 2) * kKeys; i += nthreads) {
    const int j = i >> 5, key = k0 + (i & (kKeys - 1));
    const float* src = j < sh.V ? op.ck + ((size_t)b * H + blk.head(j)) * N
                       : j == sh.V ? op.deg + (size_t)b * N
                                   : op.mask + (size_t)b * N;
    const bool valid = key < N && (j != sh.V || op.deg);
    tc::cp_async4(vst + i, valid ? src + key : dummy, valid);
  }
}

// Key tile k0's vw rows of every staged head into dst [V][32][kLD].
__device__ __forceinline__ void stage_vw(float* dst, const Block& blk,
                                         Shape sh,
                                         const graphit::Operands& op, int k0,
                                         int H, int N, int DV) {
  stage_rows64(
      dst, sh.V * kKeys, DV, vec_rows(op.vw, DV),
      [&](int r) -> const float* {
        const int key = k0 + (r & (kKeys - 1));
        return key < N ? op.vw + (((size_t)blk.b * H + blk.head(r >> 5)) * N +
                                  key) * DV
                       : nullptr;
      },
      op.x);
}

}  // namespace strips
