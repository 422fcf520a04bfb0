// Fused GraphiT attention for small graphs (N <= 128, D <= 64), forward and
// backward, f32, for sm_90a: one thread-block cluster per graph, one CTA per
// (graph, head group), one warp per 16-query strip, every product but the
// score on the tensor cores.
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
// and the backward of out: dxa_h = ds x, dx = sum_h ds^T xa_h, dcq and dck
// the row and column sums of ds, dc0 its sum (per graph and head; the
// wrapper sums it over graphs) and dvw_h = attn^T g, with the guard branch
// of modulation.cu (du = g where |denom| <= 1e-9).
//
// Grid. One cluster of C CTAs per graph, C the largest divisor of H that is
// at most 8 (the portable cluster size, `cluster_size`): CTA r of graph b's
// cluster takes heads r H/C .. (r + 1) H/C - 1 in order, so H = 8 gives one
// head a CTA and a prime H > 8 one CTA of all heads. The TPU carried the
// sum over heads in VMEM scratch across a sequential grid axis. Here each
// CTA leaves its head group's partial of out (forward) or dx (backward),
// [N, D], in its own shared memory; the cluster syncs; CTA r sums rows r,
// r + C, ... over the cluster's CTAs in rank order 0 .. C-1 through
// distributed shared memory (`cluster.map_shared_rank`) and writes them;
// a second cluster sync keeps every CTA's shared memory alive until all
// have read it. The order is fixed and there are no atomics anywhere:
// every output is bit-identical run to run.
//
// Warps. Warp w owns the 16 queries 16 w .. 16 w + 15 (the mma's M),
// ceil(N / 16) warps: 3 at N = 48, 8 at N = 128. A query's N <= 128 keys
// fit the strip's registers, so the softmax is exact, with no rescaling:
//   1. the score as the FMA chain that every flash kernel shares
//      (graphit_tile.cuh's dot4, k in order) at the thread's C-fragment
//      positions, queries g (+8) and keys 8 n + 2 t (+1), n < NK / 8 (N
//      rounded to 8 in the key dimension); forward and backward recompute
//      one and the same score;
//   2. the row's max, exp and sums in registers, each sum the thread's keys
//      in order, then its row's 4 lanes (xor 1, 2); the forward's
//      normaliser qmask / (guard ? su : se) and the backward's 1 / safe one
//      division a row; the backward's a = e / se one a score, as the plain
//      version takes it (a reciprocal of se put dck at 2.3x the CPU float32
//      route's error from float64, PERF.md);
//   3. forward: P = attn in registers is P·V's A fragment (`frag_a_from_c`,
//      vw's rows permuted alike), the head group's out in one accumulator.
//      Backward: ga = g vw_h^T on the tensor cores beside the score; the
//      row sums r = sum gm a pd and t = sum da a; ds and attn in registers;
//      dcq the row sum of ds; dxa = ds x from registers as P·V; then attn,
//      and after it ds, into shared memory [query][key] for the transposed
//      products, where warp w takes keys 16 w .. + 15: dvw_h = attn^T g and
//      dx += ds^T xa_h, K = the queries in order. dck is the column sums of
//      ds over each strip (its two rows, then the strip's 8 row lanes, xor
//      4, 8, 16) added over the strips in strip order; dc0 the sum of dck
//      in one warp's fixed order.
// Every product but the score runs on the tensor cores in 3xTF32
// (mma_tf32.cuh), a fresh fragment per 8-deep k-step added to an f32
// accumulator.
//
// Staging: cp.async (mma_tf32.cuh's stage_rows), rows past N and columns
// past D (to D rounded to 8) zero-filled by the copy: x[b], g[b], the key
// mask and degree once a CTA; xa_h, vw_h and ck_h each head, in two commit
// groups, so that the second (forward: vw; backward: pe) arrives while the
// score runs. The forward reads pe once, from device memory, as it takes
// each score's exp; the backward stages it (its passes read pe four
// times). Rows of D floats at a stride of 68 (fragment loads on 32 banks,
// mma_tf32.cuh's note); the backward's [query][key] tile (pe, then attn,
// then ds, in one buffer) at a stride LP = NR + 8, 8 or 24 more than a
// multiple of 32, so that the C fragments' float2 stores and the
// transposed A loads (`load_a_t`) hit distinct banks.
//
// Shared memory in floats, NR = N rounded to 16, W = NR / 16 warps:
//   forward  3 NR 68 (x, xa, vw) + 3 NR (mask, deg, ck)
//   backward 4 NR 68 (x, xa, vw, g) + NR LP (pe, attn, ds) + 3 NR
//            + W NR (the strips' column sums of ds) + NR (dck)
// At N = 48, D = 64: 39,744 and 64,320 bytes (five and three CTAs an SM);
// at N = 128: 105,984 bytes, the forward held to 128 registers so that two
// CTAs share an SM, and 215,040, one. The head group's partial of out or
// dx then lies in the xa rows, which nothing reads after the last head.
//
// What bounds them. At the ZINC batch B = 128, H = 8, N = 48, D = 64
// (chip_smoke.fused_cost) the forward does 0.604 GFLOP and must move 29.9
// MB, the backward 1.51 GFLOP and 57 MB. Bound of what they issue, the
// score's FMAs on the CUDA cores beside the other products as 3xTF32 at the
// TF32 peak (chip_smoke.bound_tc): bytes, forward 0.0089 ms, backward
// 0.0170 ms. All in f32 on the CUDA cores: operations, 0.0090 and 0.0225
// ms. mma.sync's m16n8k8 TF32 product runs near a quarter of that peak
// (PERF.md), so the backward's 576 mma.sync a warp at N = 48 take near
// 0.03 ms of the card alone, and a launch in clusters of 8 costs about
// 0.006 ms more than one without (kernel_ab.py's variants, PERF.md).
//
// Limits: N <= 128 (a strip's key row in registers; the backward's shared
// memory), D <= 64 (the 68-float rows), any H >= 1.
//
// C interface (ctypes): pointers and the stream as void*, returns the
// cudaError_t of the launch.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

#include "graphit_tile.cuh"
#include "mma_tf32.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kStrip = 16;           // queries a warp (the mma's M)
constexpr int kLD = 68;              // rows of up to 64 floats
constexpr int kMaxW = 64;            // D
constexpr int kMaxNodes = 128;       // N
constexpr int kMaxCluster = 8;       // the portable cluster size
constexpr size_t kMaxSmem = 232448;  // 227 KB, the H100's per-block limit

struct Ops {
  const float *xa, *x, *cq, *ck, *c0, *vw, *pe, *deg, *mask;
};

struct Geo {
  int NR;   // N rounded to 16: strips and staged rows
  int NK;   // N rounded to 8: keys, and the K of the transposed products
  int D8;   // D rounded to 8
  int LP;   // row stride of the [query][key] tiles: 8 or 24 mod 32
  int W;    // warps
};

__host__ __device__ inline Geo geometry(int N, int D) {
  Geo g;
  g.NR = (N + 15) & ~15;
  g.NK = (N + 7) & ~7;
  g.D8 = (D + 7) & ~7;
  g.LP = g.NR + 8;
  g.W = g.NR / kStrip;
  return g;
}

__host__ __device__ inline size_t smem_floats(Geo g, bool bwd) {
  const size_t vecs = 3 * (size_t)g.NR;   // key mask, degree, ck
  if (!bwd) return 3 * (size_t)g.NR * kLD + vecs;
  return 4 * (size_t)g.NR * kLD + (size_t)g.NR * g.LP + vecs +
         (size_t)(g.W + 1) * g.NR;
}

// the largest divisor of H that is at most 8: the CTAs of a graph's cluster
__host__ inline int cluster_size(int H) {
  for (int c = kMaxCluster; c > 1; --c)
    if (H % c == 0) return c;
  return 1;
}

// Block-wide cp.async of rows [NR][kLD] from src [N][D] and of a vector
// [NR] from src [N], zero past N and (rows) from D to D rounded to 8.
__device__ __forceinline__ void stage_mat(float* dst, const float* src,
                                          int N, int D, int NR) {
  tc::stage_rows(dst, kLD, src, D, 0, NR, N, 0, D, D, threadIdx.x,
                 blockDim.x);
}

__device__ __forceinline__ void stage_vec(float* dst, const float* src,
                                          int N, int NR) {
  tc::stage_rows(dst, NR, src, 0, 0, 1, 1, 0, NR, N, threadIdx.x,
                 blockDim.x);
}

// The graph's key mask and degree (ones where absent) into [NR] each.
__device__ __forceinline__ void stage_keys(const Ops& op, int b, int N,
                                           Geo geo, float* kms, float* dgs) {
  stage_vec(kms, op.mask + (size_t)b * N, N, geo.NR);
  if (op.deg)
    stage_vec(dgs, op.deg + (size_t)b * N, N, geo.NR);
  else
    for (int j = threadIdx.x; j < geo.NR; j += blockDim.x) dgs[j] = 1.f;
}

// pe[b] into [NR][LP], if given.
__device__ __forceinline__ void stage_pe(const Ops& op, int b, int N, Geo geo,
                                         float* ps) {
  if (op.pe)
    tc::stage_rows(ps, geo.LP, op.pe + (size_t)b * N * N, N, 0, geo.NR, N, 0,
                   N, N, threadIdx.x, blockDim.x);
}

// s[n][i] = xa_h[q] · x[key] as the FMA chain of graphit::dot4, k in order,
// at the thread's C-fragment positions: q = strip row g (i < 2) or g + 8,
// key = 8 n + 2 t (+1 for odd i), for 8 n < NK.
template <int NT>
__device__ __forceinline__ void score_chain(const float* xq, const float* xs,
                                            Geo geo, float (&s)[NT][4]) {
  const int g = tc::lane_g(), t = tc::lane_t();
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) s[n][i] = 0.f;
  const float* qrow = xq + g * kLD;
#pragma unroll 2
  for (int k = 0; k < kMaxW; k += 4) {
    if (k < geo.D8) {
      const float4 qv[2] = {graphit::ld4(qrow + k),
                            graphit::ld4(qrow + 8 * kLD + k)};
#pragma unroll
      for (int n = 0; n < NT; ++n)
        if (8 * n < geo.NK)
#pragma unroll
          for (int f = 0; f < 2; ++f) {
            const float4 kv = graphit::ld4(xs + (8 * n + 2 * t + f) * kLD + k);
#pragma unroll
            for (int e = 0; e < 2; ++e)
              s[n][2 * e + f] = graphit::dot4(qv[e], kv, s[n][2 * e + f]);
          }
    }
  }
}

// The masked, scaled score in place (keys >= N: -inf) and each row's max
// over the strip's row lanes.
template <int NT>
__device__ __forceinline__ void mask_and_max(float (&s)[NT][4], Geo geo,
                                             int N, const float (&cq)[2],
                                             const float* cks,
                                             const float* kms, float c0h,
                                             float inv_sqrt, float (&m)[2]) {
  const int t = tc::lane_t();
  m[0] = m[1] = -INFINITY;
#pragma unroll
  for (int n = 0; n < NT; ++n)
    if (8 * n < geo.NK)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = 8 * n + 2 * t + (i & 1);
        s[n][i] = key < N ? graphit::score(s[n][i], cq[i >> 1], cks[key],
                                           c0h, inv_sqrt, kms[key])
                          : -INFINITY;
        m[i >> 1] = fmaxf(m[i >> 1], s[n][i]);
      }
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    m[e] = fmaxf(m[e], __shfl_xor_sync(0xffffffffu, m[e], 1));
    m[e] = fmaxf(m[e], __shfl_xor_sync(0xffffffffu, m[e], 2));
  }
}

// a row sum of the thread's keys (in order) over its row's 4 lanes
__device__ __forceinline__ float lanes(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// pe[q][key, key + 1] * deg[key, key + 1] (either may be absent: 1)
__device__ __forceinline__ float2 pd_pair(const float* ps, int LP,
                                          bool has_pe, const float* dgs,
                                          int q, int key) {
  const float2 p = has_pe ? *reinterpret_cast<const float2*>(ps + q * LP + key)
                          : make_float2(1.f, 1.f);
  return make_float2(p.x * dgs[key], p.y * dgs[key + 1]);
}

// the same from device memory: pe[b] (nullptr: ones), 0 past N
__device__ __forceinline__ float2 pd_global(const float* pe_b, int N,
                                            const float* dgs, int q,
                                            int key) {
  float2 p = make_float2(1.f, 1.f);
  if (pe_b) {
    const float* row = pe_b + (size_t)q * N;
    p.x = q < N && key < N ? __ldg(row + key) : 0.f;
    p.y = q < N && key + 1 < N ? __ldg(row + key + 1) : 0.f;
  }
  return make_float2(p.x * dgs[key], p.y * dgs[key + 1]);
}

// Rows r, r + C, ... < N of the cluster's head-group partials (each CTA's
// [.][kLD] at `part`), summed over the ranks 0 .. C-1 in order, into dst
// [N][D]. Both cluster syncs are here: the partials are complete before any
// CTA reads them, and no CTA exits while another may still read its own.
__device__ __forceinline__ void cluster_sum(float* part, float* dst, int N,
                                            int D, int C, int rank) {
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int rows = (N - rank + C - 1) / C;
  if (D % 4 == 0) {
    const int per = D / 4;
    for (int i = threadIdx.x; i < rows * per; i += blockDim.x) {
      const int row = rank + C * (i / per), c = 4 * (i % per);
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int q = 0; q < C; ++q) {
        const float4 p = *reinterpret_cast<const float4*>(
            cluster.map_shared_rank(part, q) + row * kLD + c);
        v.x += p.x;
        v.y += p.y;
        v.z += p.z;
        v.w += p.w;
      }
      *reinterpret_cast<float4*>(dst + (size_t)row * D + c) = v;
    }
  } else {
    for (int i = threadIdx.x; i < rows * D; i += blockDim.x) {
      const int row = rank + C * (i / D), c = i % D;
      float v = 0.f;
      for (int q = 0; q < C; ++q)
        v += cluster.map_shared_rank(part, q)[row * kLD + c];
      dst[(size_t)row * D + c] = v;
    }
  }
  cluster.sync();
}

// A C fragment's 16 x 64 tile, rows row0 + g (+8) and columns 8 j + 2 t
// (+1), into rows [.][kLD] of shared memory
__device__ __forceinline__ void put_tile(float* dst, int row0, Geo geo,
                                         const float (&acc)[8][4]) {
  const int g = tc::lane_g(), t = tc::lane_t();
#pragma unroll
  for (int j = 0; j < 8; ++j)
    if (8 * j < geo.D8)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        dst[(row0 + g + 8 * (i >> 1)) * kLD + 8 * j + 2 * t + (i & 1)] =
            acc[j][i];
}

// the same into dst [rows < N][D] of device memory
__device__ __forceinline__ void store_tile(float* dst, int row0, int N, int D,
                                           Geo geo,
                                           const float (&acc)[8][4]) {
  const int g = tc::lane_g(), t = tc::lane_t();
#pragma unroll
  for (int j = 0; j < 8; ++j)
    if (8 * j < geo.D8)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = row0 + g + 8 * (i >> 1);
        const int col = 8 * j + 2 * t + (i & 1);
        if (row < N && col < D) dst[(size_t)row * D + col] = acc[j][i];
      }
}

// acc[j] += P · B[k0 .. k0 + 7][8 j ..] over the row-major k-steps of a
// product whose A is the strip's C fragments p[n] (keys 8 n .. 8 n + 7)
template <int NT>
__device__ __forceinline__ void product_from_c(const float (&p)[NT][4],
                                               const float* B, Geo geo,
                                               float (&acc)[8][4]) {
#pragma unroll
  for (int n = 0; n < NT; ++n)
    if (8 * n < geo.NK) {
      const tc::FragA a = tc::frag_a_from_c(p[n]);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (8 * j < geo.D8)
          tc::mma3(acc[j], a, tc::load_b_kn_pairs(B, kLD, 8 * n, 8 * j));
    }
}

// acc[j] += sum over the queries of At^T[row0 ..][q] · B[q][8 j ..]: At the
// [query][key] tile, B rows of queries [.][kLD]; k-steps of 8 queries in
// order
__device__ __forceinline__ void product_t(const float* At, const float* B,
                                          int row0, Geo geo,
                                          float (&acc)[8][4]) {
  for (int kq = 0; kq < geo.NK; kq += 8) {
    const tc::FragA a = tc::load_a_t(At, geo.LP, row0, kq);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (8 * j < geo.D8)
        tc::mma3(acc[j], a, tc::load_b_kn(B, kLD, kq, 8 * j));
  }
}

template <int NT>
__global__ void __launch_bounds__(16 * NT, NT == 16 ? 2 : 1)
fused_fwd_kernel(Ops op, float* __restrict__ out, int H, int N, int D, int C,
                 float inv_sqrt) {
  extern __shared__ __align__(16) float smem[];
  const int rank = (int)cg::this_cluster().block_rank();
  const int b = blockIdx.x / C, hpc = H / C;
  const Geo geo = geometry(N, D);
  float* xs = smem;                     // [NR][kLD] keys x[b]
  float* xas = xs + geo.NR * kLD;       // [NR][kLD] xa_h, then the partial
  float* vws = xas + geo.NR * kLD;      // [NR][kLD] vw_h
  float* kms = vws + geo.NR * kLD;      // [NR]      key mask
  float* dgs = kms + geo.NR;            // [NR]      degree
  float* cks = dgs + geo.NR;            // [NR]      ck_h
  const int w = threadIdx.x / 32, g = tc::lane_g(), t = tc::lane_t();
  const int q0 = kStrip * w;
  const float* pe_b = op.pe ? op.pe + (size_t)b * N * N : nullptr;

  float qm[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int q = q0 + g + 8 * e;
    qm[e] = q < N ? op.mask[(size_t)b * N + q] : 0.f;
  }
  float acc[8][4] = {};   // the head group's out, rows q0 + g (+8)
  for (int hh = 0; hh < hpc; ++hh) {
    const int h = rank * hpc + hh;
    const size_t bh = (size_t)b * H + h;
    if (hh == 0) {
      stage_mat(xs, op.x + (size_t)b * N * D, N, D, geo.NR);
      stage_keys(op, b, N, geo, kms, dgs);
    } else {
      __syncthreads();   // every warp done with xa, vw and ck
    }
    stage_mat(xas, op.xa + bh * N * D, N, D, geo.NR);
    stage_vec(cks, op.ck + bh * N, N, geo.NR);
    tc::cp_async_commit();
    stage_mat(vws, op.vw + bh * N * D, N, D, geo.NR);
    tc::cp_async_commit();
    float cq[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int q = q0 + g + 8 * e;
      cq[e] = q < N ? op.cq[bh * N + q] : 0.f;
    }
    tc::cp_async_wait<1>();
    __syncthreads();   // x, xa, ck, mask and degree visible

    float s[NT][4], m[2];
    score_chain<NT>(xas + q0 * kLD, xs, geo, s);
    mask_and_max<NT>(s, geo, N, cq, cks, kms, op.c0[h], inv_sqrt, m);

    // e = exp(s - m), u = e pd (pe read once, from device memory); P = u
    // kmask qmask / (guard ? su : se)
    float se[2] = {0.f, 0.f}, su[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < NT; ++n)
      if (8 * n < geo.NK)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = 8 * n + 2 * t;
          const float2 pd = pd_global(pe_b, N, dgs, q0 + g + 8 * e, key);
#pragma unroll
          for (int f = 0; f < 2; ++f) {
            const int i = 2 * e + f;
            const float ex = expf(s[n][i] - m[e]);
            const float u = ex * (f ? pd.y : pd.x);
            se[e] += ex;
            su[e] += u;
            s[n][i] = u * kms[key + f];
          }
        }
    float r[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      se[e] = lanes(se[e]);
      su[e] = lanes(su[e]);
      r[e] = qm[e] / (fabsf(su[e] / se[e]) > graphit::kEps ? su[e] : se[e]);
    }
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[n][i] *= r[i >> 1];
    tc::cp_async_wait_all();
    __syncthreads();   // vw visible
    product_from_c<NT>(s, vws, geo, acc);   // += attn_h vw_h
  }
  __syncwarp();   // the warp's lanes done with its xa rows
  put_tile(xas, q0, geo, acc);
  cluster_sum(xas, out + (size_t)b * N * D, N, D, C, rank);
}

template <int NT>
__global__ void __launch_bounds__(16 * NT)
fused_bwd_kernel(Ops op, const float* __restrict__ gt,
                 float* __restrict__ dxa, float* __restrict__ dx,
                 float* __restrict__ dcq, float* __restrict__ dck,
                 float* __restrict__ dc0, float* __restrict__ dvw, int H,
                 int N, int D, int C, float inv_sqrt) {
  extern __shared__ __align__(16) float smem[];
  const int rank = (int)cg::this_cluster().block_rank();
  const int b = blockIdx.x / C, hpc = H / C;
  const Geo geo = geometry(N, D);
  float* xs = smem;                     // [NR][kLD] keys x[b]
  float* xas = xs + geo.NR * kLD;       // [NR][kLD] xa_h, then the partial
  float* vws = xas + geo.NR * kLD;      // [NR][kLD] vw_h
  float* gs = vws + geo.NR * kLD;       // [NR][kLD] g[b]
  float* ps = gs + geo.NR * kLD;        // [NR][LP]  pe, then attn, then ds
  float* kms = ps + geo.NR * geo.LP;    // [NR]      key mask
  float* dgs = kms + geo.NR;            // [NR]      degree
  float* cks = dgs + geo.NR;            // [NR]      ck_h
  float* cols = cks + geo.NR;           // [W][NR]   the strips' sums of ds
  float* dcks = cols + geo.W * geo.NR;  // [NR]      dck_h
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = tc::lane_g(), t = tc::lane_t();
  const int q0 = kStrip * w;            // the strip, and the key tile
  const int tid = threadIdx.x;
  const bool has_pe = op.pe != nullptr;

  float qm[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int q = q0 + g + 8 * e;
    qm[e] = q < N ? op.mask[(size_t)b * N + q] : 0.f;
  }
  float dxacc[8][4] = {};   // the head group's dx, keys q0 + g (+8)
  for (int hh = 0; hh < hpc; ++hh) {
    const int h = rank * hpc + hh;
    const size_t bh = (size_t)b * H + h;
    if (hh == 0) {
      stage_mat(xs, op.x + (size_t)b * N * D, N, D, geo.NR);
      stage_mat(gs, gt + (size_t)b * N * D, N, D, geo.NR);
      stage_keys(op, b, N, geo, kms, dgs);
    } else {
      __syncthreads();   // every warp done with xa, vw, ck and ps
    }
    stage_mat(xas, op.xa + bh * N * D, N, D, geo.NR);
    stage_mat(vws, op.vw + bh * N * D, N, D, geo.NR);
    stage_vec(cks, op.ck + bh * N, N, geo.NR);
    tc::cp_async_commit();
    stage_pe(op, b, N, geo, ps);
    tc::cp_async_commit();
    float cq[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int q = q0 + g + 8 * e;
      cq[e] = q < N ? op.cq[bh * N + q] : 0.f;
    }
    tc::cp_async_wait<1>();
    __syncthreads();   // x, g, xa, vw, ck, mask and degree visible

    // the score on the CUDA cores, ga = g vw_h^T on the tensor cores
    float s[NT][4], ga[NT][4] = {}, m[2];
    score_chain<NT>(xas + q0 * kLD, xs, geo, s);
    for (int kk = 0; kk < geo.D8; kk += 8) {
      const tc::FragA a = tc::load_a(gs, kLD, q0, kk);
#pragma unroll
      for (int n = 0; n < NT; ++n)
        if (8 * n < geo.NK)
          tc::mma3(ga[n], a, tc::load_b_nk(vws, kLD, 8 * n, kk));
    }
    mask_and_max<NT>(s, geo, N, cq, cks, kms, op.c0[h], inv_sqrt, m);
    tc::cp_async_wait_all();
    __syncthreads();   // pe visible

    // the row: e = exp(s - m) in s; se, su; the guard and 1 / safe
    float se[2] = {0.f, 0.f}, su[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < NT; ++n)
      if (8 * n < geo.NK)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float2 pd = pd_pair(ps, geo.LP, has_pe, dgs, q0 + g + 8 * e,
                                    8 * n + 2 * t);
#pragma unroll
          for (int f = 0; f < 2; ++f) {
            const int i = 2 * e + f;
            s[n][i] = expf(s[n][i] - m[e]);
            se[e] += s[n][i];
            su[e] += s[n][i] * (f ? pd.y : pd.x);
          }
        }
    float isafe[2], on[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      se[e] = lanes(se[e]);
      su[e] = lanes(su[e]);
      on[e] = fabsf(su[e] / se[e]) > graphit::kEps ? 1.f : 0.f;
      isafe[e] = on[e] > 0.f ? se[e] / su[e] : 1.f;
    }
    // the backward of the chain: a = e / se (in s), gm = ga qmask kmask,
    // r = sum gm a pd, du = gm / safe - guard r / safe^2, da = du pd (in
    // ga), t = sum da a, ds = a (da - t) inv_sqrt (in s), attn = a pd / safe
    // qmask kmask
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < NT; ++n)
      if (8 * n < geo.NK)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = 8 * n + 2 * t;
          const float2 pd = pd_pair(ps, geo.LP, has_pe, dgs, q0 + g + 8 * e,
                                    key);
#pragma unroll
          for (int f = 0; f < 2; ++f) {
            const int i = 2 * e + f;
            const float gm = ga[n][i] * (qm[e] * kms[key + f]);
            s[n][i] = s[n][i] / se[e];
            rs[e] += gm * s[n][i] * (f ? pd.y : pd.x);
          }
        }
    float beta[2], ts[2] = {0.f, 0.f};
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      rs[e] = lanes(rs[e]);
      beta[e] = rs[e] * isafe[e] * isafe[e] * on[e];
    }
#pragma unroll
    for (int n = 0; n < NT; ++n)
      if (8 * n < geo.NK)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = 8 * n + 2 * t;
          const float2 pd = pd_pair(ps, geo.LP, has_pe, dgs, q0 + g + 8 * e,
                                    key);
#pragma unroll
          for (int f = 0; f < 2; ++f) {
            const int i = 2 * e + f;
            const float gm = ga[n][i] * (qm[e] * kms[key + f]);
            const float da = (gm * isafe[e] - beta[e]) * (f ? pd.y : pd.x);
            ga[n][i] = da;
            ts[e] += da * s[n][i];
          }
        }
    float rowsum[2] = {0.f, 0.f};
#pragma unroll
    for (int e = 0; e < 2; ++e) ts[e] = lanes(ts[e]);
#pragma unroll
    for (int n = 0; n < NT; ++n)
      if (8 * n < geo.NK)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = 8 * n + 2 * t;
          float* at = ps + (q0 + g + 8 * e) * geo.LP + key;
          const float2 pd = pd_pair(ps, geo.LP, has_pe, dgs, q0 + g + 8 * e,
                                    key);
          float attn[2];
#pragma unroll
          for (int f = 0; f < 2; ++f) {
            const int i = 2 * e + f;
            const float a = s[n][i];
            attn[f] = a * (f ? pd.y : pd.x) * isafe[e] *
                      (qm[e] * kms[key + f]);
            s[n][i] = a * (ga[n][i] - ts[e]) * inv_sqrt;   // ds
            rowsum[e] += s[n][i];
          }
          *reinterpret_cast<float2*>(at) = make_float2(attn[0], attn[1]);
        }
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      rowsum[e] = lanes(rowsum[e]);
      const int q = q0 + g + 8 * e;
      if (t == 0 && q < N) dcq[bh * N + q] = rowsum[e];
    }
    // the strip's column sums of ds: its rows g and g + 8, then the 8 rows
    // g of its lanes (xor 4, 8, 16)
#pragma unroll
    for (int n = 0; n < NT; ++n)
      if (8 * n < geo.NK)
#pragma unroll
        for (int f = 0; f < 2; ++f) {
          float v = s[n][f] + s[n][2 + f];
          v += __shfl_xor_sync(0xffffffffu, v, 4);
          v += __shfl_xor_sync(0xffffffffu, v, 8);
          v += __shfl_xor_sync(0xffffffffu, v, 16);
          if (g == 0) cols[w * geo.NR + 8 * n + 2 * t + f] = v;
        }
    {   // dxa_h = ds x, ds in registers
      float acc[8][4] = {};
      product_from_c<NT>(s, xs, geo, acc);
      store_tile(dxa + bh * N * D, q0, N, D, geo, acc);
    }
    __syncthreads();   // attn and the strips' column sums complete
    {   // dvw_h = attn^T g for keys q0 ..
      float acc[8][4] = {};
      product_t(ps, gs, q0, geo, acc);
      store_tile(dvw + bh * N * D, q0, N, D, geo, acc);
    }
    if (tid < N) {   // dck: the strips' sums in strip order
      float v = 0.f;
      for (int u = 0; u < geo.W; ++u) v += cols[u * geo.NR + tid];
      dck[bh * N + tid] = v;
      dcks[tid] = v;
    }
    __syncthreads();   // every warp done with attn; dck complete
#pragma unroll
    for (int n = 0; n < NT; ++n)
      if (8 * n < geo.NK)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          *reinterpret_cast<float2*>(ps + (q0 + g + 8 * e) * geo.LP + 8 * n +
                                     2 * t) =
              make_float2(s[n][2 * e], s[n][2 * e + 1]);
    if (w == 0) {   // dc0: lanes over the keys, then xor 16 .. 1
      float v = 0.f;
      for (int j = lane; j < N; j += 32) v += dcks[j];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        v += __shfl_xor_sync(0xffffffffu, v, off);
      if (lane == 0) dc0[bh] = v;
    }
    __syncthreads();   // ds complete
    product_t(ps, xas, q0, geo, dxacc);   // dx += ds^T xa_h, keys q0 ..
  }
  __syncthreads();   // every warp done with the xa rows
  put_tile(xas, q0, geo, dxacc);
  cluster_sum(xas, dx + (size_t)b * N * D, N, D, C, rank);
}

bool bad_shape(int B, int H, int N, int D) {
  return B <= 0 || H <= 0 || N <= 0 || N > kMaxNodes || D <= 0 ||
         D > kMaxW || (long long)B * cluster_size(H) > 0x7fffffffLL;
}

// key n-tiles of the kernel that takes N: 4 (N <= 32), 8 (<= 64) or 16
int key_tiles(int N) { return N <= 32 ? 4 : N <= 64 ? 8 : 16; }

// The launch of either kernel: B clusters of C CTAs of W warps.
cudaLaunchConfig_t config(int B, int H, int N, int D, bool bwd,
                          cudaStream_t stream, cudaLaunchAttribute* attr) {
  const Geo geo = geometry(N, D);
  const int C = cluster_size(H);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * C);
  cfg.blockDim = dim3(32 * geo.W);
  cfg.dynamicSmemBytes = sizeof(float) * smem_floats(geo, bwd);
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = C;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <class Kernel, class... Args>
int launch(Kernel kernel, const cudaLaunchConfig_t& cfg, Args... args) {
  if (cfg.dynamicSmemBytes > kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)cfg.dynamicSmemBytes);
  if (err != cudaSuccess) return (int)err;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <class Kernel>
int max_clusters(Kernel kernel, const cudaLaunchConfig_t& cfg) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)cfg.dynamicSmemBytes);
  int n = 0;
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveClusters(&n, kernel,
                                                               &cfg);
  return err == cudaSuccess ? n : -(int)err;
}

Ops ops(const void* xa, const void* x, const void* cq, const void* ck,
        const void* c0, const void* vw, const void* pe, const void* deg,
        const void* mask) {
  return Ops{(const float*)xa, (const float*)x,  (const float*)cq,
             (const float*)ck, (const float*)c0, (const float*)vw,
             (const float*)pe, (const float*)deg, (const float*)mask};
}

}  // namespace

extern "C" int feta_fused_attn_fwd(const void* xa, const void* x,
                                   const void* cq, const void* ck,
                                   const void* c0, const void* vw,
                                   const void* pe, const void* deg,
                                   const void* mask, void* out, int B, int H,
                                   int N, int D, float inv_sqrt,
                                   void* stream) {
  if (bad_shape(B, H, N, D)) return (int)cudaErrorInvalidValue;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      config(B, H, N, D, false, (cudaStream_t)stream, &attr);
  const Ops op = ops(xa, x, cq, ck, c0, vw, pe, deg, mask);
  const int C = cluster_size(H);
  switch (key_tiles(N)) {
    case 4:
      return launch(fused_fwd_kernel<4>, cfg, op, (float*)out, H, N, D, C,
                    inv_sqrt);
    case 8:
      return launch(fused_fwd_kernel<8>, cfg, op, (float*)out, H, N, D, C,
                    inv_sqrt);
    default:
      return launch(fused_fwd_kernel<16>, cfg, op, (float*)out, H, N, D, C,
                    inv_sqrt);
  }
}

extern "C" int feta_fused_attn_bwd(const void* xa, const void* x,
                                   const void* cq, const void* ck,
                                   const void* c0, const void* vw,
                                   const void* pe, const void* deg,
                                   const void* mask, const void* g, void* dxa,
                                   void* dx, void* dcq, void* dck, void* dc0,
                                   void* dvw, int B, int H, int N, int D,
                                   float inv_sqrt, void* stream) {
  if (bad_shape(B, H, N, D)) return (int)cudaErrorInvalidValue;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      config(B, H, N, D, true, (cudaStream_t)stream, &attr);
  const Ops op = ops(xa, x, cq, ck, c0, vw, pe, deg, mask);
  const int C = cluster_size(H);
#define FETA_FUSED_BWD(NT)                                                   \
  launch(fused_bwd_kernel<NT>, cfg, op, (const float*)g, (float*)dxa,      \
         (float*)dx, (float*)dcq, (float*)dck, (float*)dc0, (float*)dvw, H, \
         N, D, C, inv_sqrt)
  switch (key_tiles(N)) {
    case 4:
      return FETA_FUSED_BWD(4);
    case 8:
      return FETA_FUSED_BWD(8);
    default:
      return FETA_FUSED_BWD(16);
  }
#undef FETA_FUSED_BWD
}

// The CTAs of a graph's cluster for H heads (the wrapper's `cluster_size`).
extern "C" int feta_fused_attn_cluster(int H) { return cluster_size(H); }

// cudaOccupancyMaxActiveClusters of the launch that the forward (bwd = 0)
// or the backward (bwd = 1) makes at (B, H, N, D), or minus its error.
extern "C" int feta_fused_attn_max_clusters(int bwd, int B, int H, int N,
                                            int D) {
  if (bad_shape(B, H, N, D)) return -(int)cudaErrorInvalidValue;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = config(B, H, N, D, bwd != 0, 0, &attr);
  switch (key_tiles(N)) {
    case 4:
      return bwd ? max_clusters(fused_bwd_kernel<4>, cfg)
                 : max_clusters(fused_fwd_kernel<4>, cfg);
    case 8:
      return bwd ? max_clusters(fused_bwd_kernel<8>, cfg)
                 : max_clusters(fused_fwd_kernel<8>, cfg);
    default:
      return bwd ? max_clusters(fused_bwd_kernel<16>, cfg)
                 : max_clusters(fused_fwd_kernel<16>, cfg);
  }
}

extern "C" const char* feta_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
