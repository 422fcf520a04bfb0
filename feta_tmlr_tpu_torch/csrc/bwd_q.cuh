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
// Strips. A block owns S strips of 16 queries, a strip being one head's 16
// consecutive queries, and loops over the keys in 32-key tiles:
//   unfolded: one block per (b, 64-query tile, h), h fastest so that the H
//     blocks reading one pe tile meet in L2; its S = 4 strips are head h's
//     queries 16 s .. 16 s + 15 of the tile;
//   folded:   one block per (b, 16-query tile) for all H <= 8 heads; strip
//     s is head s's 16 queries, and the heads share the staged x, pe, deg
//     and key mask (the TPU's reason to fold).
// Two warps a strip, warp 2 s + u, 8 warps (unfolded) or 2H (folded).
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
// Staging, by cp.async. Once: the strips' xa and g rows [16 S][kLD]. Per key
// tile, a two-stage ring {x [32][kLD], pe [P][kLDP], ck [V][32], deg [32],
// key mask [32]} (P = 64 query rows unfolded, 16 folded; V = 1 head
// unfolded, H folded): tile t + 1 loads while tile t computes. vw [V][32]
// [kLD] has one buffer, refilled for tile t + 1 after phase 1 of tile t
// and landing during its phase 2: a second one would take the folded block
// past the SM's 227 KB at H=8. Shared memory at D = DV = 64: unfolded
// 91,904 bytes (two blocks an SM, 128 registers a thread), folded 183,808
// bytes at H=8 (one block of 16 warps an SM).
//
// What bounds it: instruction issue and mma.sync's TF32 rate. A warp's
// tile is 512 score FMAs beside 96 TF32 mma.sync (48 a product) and their
// operand splits (mma_tf32.cuh); the bound of what it issues is the
// score's FMAs at 67 TFLOP/s beside the two 3xTF32 products at the TF32
// peak (PERF.md). Rows and keys >= N contribute exactly 0 and are not
// stored; rows of width w < 64 are zero-filled to 64, so the K edge of
// D and DV not multiples of 8 adds exact zeros.

#pragma once

#include <cuda_runtime.h>

#include "graphit_tile.cuh"
#include "mma_tf32.cuh"

namespace bwdq {

constexpr int kKeys = 32;          // keys per tile
constexpr int kStrip = 16;         // queries per strip
constexpr int kLD = 68;            // rows of up to 64 floats, padded
constexpr int kLDS = kKeys + 4;    // ds [query][key]: A loads conflict-free
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

__host__ __device__ inline int stage_floats(Shape sh) {
  return kKeys * kLD + sh.P * kLDP + (sh.V + 2) * kKeys;
}

__host__ __device__ inline size_t smem_floats(Shape sh) {
  const size_t rows = (size_t)sh.S * kStrip;
  return 2 * rows * kLD + rows * kLDS + (size_t)sh.V * kKeys * kLD +
         2 * (size_t)stage_floats(sh) + 2 * rows;
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

template <bool kFold>
__global__ void __launch_bounds__(kFold ? 64 * kMaxHeads : 256,
                                  kFold ? 1 : 2)
bwd_q_kernel(graphit::Operands op, float* __restrict__ dxa,
             float* __restrict__ dcq, int H, int N, int D, int DV,
             float inv_sqrt) {
  extern __shared__ float smem[];
  const Shape sh = shape(kFold, H);
  const int rows = sh.S * kStrip, stage = stage_floats(sh);
  float* xas = smem;                     // [16 S][kLD]  the strips' xa
  float* gs = xas + rows * kLD;          // [16 S][kLD]  their cotangents
  float* dss = gs + rows * kLD;          // [16 S][kLDS] ds of the tile
  float* vws = dss + rows * kLDS;        // [V][32][kLD] its values
  float* ring = vws + sh.V * kKeys * kLD;
  float* red = ring + 2 * stage;         // [2][16 S]    dcq of each warp

  // the block's queries and heads
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
  const int b = bid;
  // strip s: head, first query
  auto head = [&](int s) { return kFold ? s : hb; };
  auto first = [&](int s) { return kFold ? q0 : q0 + kStrip * s; };

  const int tid = threadIdx.x, warp = tid / 32;
  const int g = tc::lane_g(), t = tc::lane_t();
  const int s = warp >> 1, u = warp & 1;
  const int hs = head(s), qs0 = first(s);
  const size_t bhs = (size_t)b * H + hs;
  const float* pe_b = op.pe ? op.pe + (size_t)b * N * N : nullptr;
  const float* dummy = op.x;

  // the query side, once
  {
    auto row_of = [&](const float* base, int w) {
      return [=](int r) -> const float* {
        const int sr = r >> 4, q = first(sr) + (r & 15);
        return q < N ? base + (((size_t)b * H + head(sr)) * N + q) * w
                     : nullptr;
      };
    };
    const bool vx = D % 4 == 0 && reinterpret_cast<size_t>(op.xa) % 16 == 0;
    const bool vg = DV % 4 == 0 && reinterpret_cast<size_t>(op.g) % 16 == 0;
    stage_rows64(xas, rows, D, vx, row_of(op.xa, D), dummy);
    stage_rows64(gs, rows, DV, vg, row_of(op.g, DV), dummy);
  }

  const bool vec_x =
      D % 4 == 0 && reinterpret_cast<size_t>(op.x) % 16 == 0;
  const bool vec_vw =
      DV % 4 == 0 && reinterpret_cast<size_t>(op.vw) % 16 == 0;
  const bool vec_pe =
      pe_b && N % 4 == 0 && reinterpret_cast<size_t>(op.pe) % 16 == 0;

  // tile k0's x, pe, ck, deg and key mask into ring stage `st`
  auto issue_keys = [&](int k0, int st) {
    float* xst = ring + st * stage;
    float* pst = xst + kKeys * kLD;
    float* vst = pst + sh.P * kLDP;     // ck [V][32], deg [32], mask [32]
    stage_rows64(
        xst, kKeys, D, vec_x,
        [=](int r) -> const float* {
          return k0 + r < N ? op.x + ((size_t)b * N + k0 + r) * D : nullptr;
        },
        dummy);
    if (pe_b) {
      if (vec_pe) {
        for (int i = tid; i < sh.P * kKeys / 4; i += blockDim.x) {
          const int r = i >> 3, c = (i & 7) * 4, q = q0 + r;
          const bool valid = q < N && k0 + c < N;
          tc::cp_async16(pst + r * kLDP + c,
                         valid ? pe_b + (size_t)q * N + k0 + c : dummy,
                         valid);
        }
      } else {
        for (int i = tid; i < sh.P * kKeys; i += blockDim.x) {
          const int r = i >> 5, c = i & (kKeys - 1), q = q0 + r;
          const bool valid = q < N && k0 + c < N;
          tc::cp_async4(pst + r * kLDP + c,
                        valid ? pe_b + (size_t)q * N + k0 + c : dummy,
                        valid);
        }
      }
    }
    for (int i = tid; i < (sh.V + 2) * kKeys; i += blockDim.x) {
      const int j = i >> 5, key = k0 + (i & (kKeys - 1));
      const float* src = j < sh.V ? op.ck + ((size_t)b * H + head(j)) * N
                         : j == sh.V ? op.deg + (size_t)b * N
                                     : op.mask + (size_t)b * N;
      const bool valid = key < N && (j != sh.V || op.deg);
      tc::cp_async4(vst + i, valid ? src + key : dummy, valid);
    }
  };
  // tile k0's vw rows of every staged head
  auto issue_vw = [&](int k0) {
    stage_rows64(
        vws, sh.V * kKeys, DV, vec_vw,
        [=](int r) -> const float* {
          const int key = k0 + (r & (kKeys - 1));
          return key < N ? op.vw + (((size_t)b * H + head(r >> 5)) * N +
                                    key) * DV
                         : nullptr;
        },
        dummy);
  };

  issue_keys(0, 0);
  issue_vw(0);
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
      issue_keys(k0 + kKeys, (it + 1) & 1);
      tc::cp_async_commit();
    }
    const float* xst = ring + (it & 1) * stage;
    const float* pst = xst + kKeys * kLD + (kFold ? 0 : kStrip * s) * kLDP;
    const float* cks = xst + kKeys * kLD + sh.P * kLDP;
    const float* dgs = cks + sh.V * kKeys;
    const float* kms = dgs + kKeys;
    if (kFold) cks += s * kKeys;

    // 1. score (FMA chain) and ga (tensor cores), 16 queries x 16 keys
    float sc[2][4] = {}, ga[2][4] = {};
    const float* xq = xas + (kStrip * s + g) * kLD;
    const float* xk = xst + (16 * u + 2 * t) * kLD;
    const float* gq = gs + kStrip * s * kLD;
    const float* vk = vws + (kFold ? s : 0) * kKeys * kLD;
#pragma unroll
    for (int kk = 0; kk < kMaxW; kk += 8) {
      if (kk < DV8) {
        const tc::FragA a = tc::load_a(gq, kLD, 0, kk);
#pragma unroll
        for (int n = 0; n < 2; ++n)
          tc::mma3(ga[n], a, tc::load_b_nk(vk, kLD, 16 * u + 8 * n, kk));
      }
      if (kk < D8) {
#pragma unroll
        for (int k = kk; k < kk + 8; k += 4) {
          const float4 qv[2] = {graphit::ld4(xq + k),
                                graphit::ld4(xq + 8 * kLD + k)};
#pragma unroll
          for (int n = 0; n < 2; ++n)
#pragma unroll
            for (int f = 0; f < 2; ++f) {
              const float4 kv = graphit::ld4(xk + (8 * n + f) * kLD + k);
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
        const float2 pe2 = pe_b ? *reinterpret_cast<const float2*>(
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
          d2[f] = d;
        }
        *reinterpret_cast<float2*>(dss + (kStrip * s + ql) * kLDS + kl) =
            make_float2(d2[0], d2[1]);
      }
    dsum[0].add(tile[0], it);
    dsum[1].add(tile[1], it);
    __syncthreads();  // every strip's ds complete; vw no longer read
    if (it + 1 < nt) {
      issue_vw(k0 + kKeys);
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
        const int c0 = 32 * u + 8 * n;
        if (c0 < D8) tc::mma3(part[n], a, tc::load_b_kn(xst, kLD, kk, c0));
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
      const int col = 32 * u + 8 * n + 2 * t + (i & 1);
      if (q < N && col < D) dxa[(bhs * N + q) * D + col] = acc[n][i];
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
  for (int r = tid; r < rows; r += blockDim.x) {
    const int sr = r >> 4, q = first(sr) + (r & 15);
    if (q < N)
      dcq[((size_t)b * H + head(sr)) * N + q] = red[r] + red[rows + r];
  }
}

// Launch either grid: blocks of 2 S warps, dynamic shared memory set first.
template <bool kFold>
int launch(graphit::Operands op, float* dxa, float* dcq, int B, int H,
           int N, int D, int DV, float inv_sqrt, cudaStream_t stream) {
  const Shape sh = shape(kFold, H);
  const size_t smem = sizeof(float) * smem_floats(sh);
  cudaError_t err = cudaFuncSetAttribute(
      bwd_q_kernel<kFold>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int tile = kFold ? kStrip : kUnfoldedStrips * kStrip;
  const int blocks = B * ((N + tile - 1) / tile) * (kFold ? 1 : H);
  bwd_q_kernel<kFold><<<blocks, 64 * sh.S, smem, stream>>>(
      op, dxa, dcq, H, N, D, DV, inv_sqrt);
  return (int)cudaGetLastError();
}

}  // namespace bwdq
