// Backward of the online-softmax GraphiT attention, f32, for sm_90a.
//
// Replaces the two TPU kernels of feta_tmlr_tpu/ops/pallas/flash_attention.py
// launched by `_call_bwd`: `_bwd_q_kernel` (dxa, dcq) and `_bwd_k_kernel`
// (dvw, dck, dx). Both recompute the attention tiles of one (graph b,
// head h) from the forward's row statistics, as the JAX package's
// `_recompute_block` does:
//
//   s[i,j]  = (xa_h[i]·x[j] + cq[i] + ck[j] + c0) * inv_sqrt,
//             -1e30 where key j is padding (graphit_tile.cuh)
//   a[i,j]  = exp(s[i,j] - m[i]) * ise[i]
//   pd[i,j] = pe[i,j] * deg[j]                (either may be absent: 1)
//   attn    = a * pd * qa[i] * kmask[j]
//   ga[i,j] = g_h[i]·vw_h[j]                  (g: the per-head cotangent)
//   du      = ga * kmask[j] * qa[i] - beta[i]
//   ds      = a * (du * pd - c[i]) * inv_sqrt
//
// with the row constants ise = 1/se, qa = qmask/safe, beta, c computed
// outside from (m, se, su) and the cotangent (common.py,
// `bwd_row_constants`). Then
//
//   flash_bwd_q_kernel:  dxa_h = ds @ x,        dcq_h = sum_j ds
//   flash_bwd_k_kernel:  dvw_h = attn^T @ g_h,  dck_h = sum_i ds,
//                        dx    = sum_h ds^T @ xa_h
//
// What bounds them on the H100: arithmetic. Per (b, h) the q pass does
// 2·N²·(2D + DV) flops and the k pass 2·N²·(2D + 2DV); the bytes they must
// move are a few percent of what the card streams in that time.
//
// The q pass is bwd_q.cuh's kernel on the unfolded grid (its note): one
// block of 8 warps per (b, 64-query tile, h) over 32-key tiles, the score
// as the forwards' FMA chain, ga and dxa on the tensor cores in 3xTF32.
//
// The k pass takes its score as the forwards' FMA chain on the CUDA cores
// and its other three products on the tensor cores in error-compensated
// TF32 (mma_tf32.cuh: each f32 product as three TF32 products, lo·hi +
// hi·lo + hi·hi, f32 accumulators; float32 accuracy). One block of
// 256 threads (8 warps) per (b, 64-key tile, h) loops over 32-query tiles,
// which cp.async stages into a two-stage ring while the previous tile
// computes: xa, g and pe rows of 64 floats (padded to 68, so fragment loads
// hit distinct banks) and the six row constants. Warp w owns the 16 keys
// 16 (w % 4) .. + 15 of every product (the mma's M): the score s^T = x
// xa^T and the product ga^T = vw g^T over its 16 queries 16 (w / 4) .. + 15
// (K = D, DV), the elementwise ds and attn in the accumulators' registers,
// written to shared memory as attn^T and ds^T [keys][queries], then the
// update products dvw += attn^T g and dx_h += ds^T xa over its 32 output
// columns 32 (w / 4) .. + 31 (K = the 32 queries), each tile's sum into a
// fresh partial (flash_fwd.cu's note on summation order). Shared memory
// 108 KB and 128 registers (`__launch_bounds__(256, 2)`): two blocks an
// SM. What bounds it then is instruction issue: mma.sync's m16n8k8 TF32
// product takes about 15 cycles of an SM sub-partition (a quarter of what
// wgmma reaches), so the 3xTF32 products alone are near 0.4 ms at B=4,
// N=1024, H=8, D=DV=64, and the splits, fragment loads and the
// elementwise step issue beside them (PERF.md). The split itself is four
// integer and float instructions (mma_tf32.cuh).
//
// No carry between blocks. The TPU's `_bwd_k_kernel` sums dx over heads in
// scratch because h is its innermost sequential grid axis. GPU blocks run
// in no order, so the k pass writes one dx partial per head, [B, H, N, D],
// and a second launch (head_sum_kernel, same source, same wrapper) adds the
// H partials in a fixed order. A block that looped over the heads itself
// would leave only B·N/64 blocks (128 at B=8, N=1024), under one wave on
// 132 SMs; the partials cost 2 x 16 MiB of traffic at that shape, about
// 10 microseconds. No float atomics anywhere: every gradient is
// bit-identical from run to run.
//
// Grids: one block per (b, query tile, h) for the q pass and per (b, key
// tile, h) for the k pass, h fastest, so the H blocks that read the same
// pe tile run together and find it in L2. Each block loops over the other
// axis itself, so dcq and dck are complete inside one block (dck sums each
// thread's queries tile by tile into a graphit::RunSum, then the 4 lanes
// of a row and the two query halves, in a fixed order). Ragged N: rows and
// keys >= N contribute exactly 0 and are not stored; padded queries inside
// N have qa = 0 and r = 0, so ds = 0 there without a special case.
//
// C interface (ctypes): pointers and the stream as void*, returns the
// cudaError_t of the launch.

#include <cuda_runtime.h>
#include <math.h>

#include "bwd_q.cuh"
#include "graphit_tile.cuh"
#include "mma_tf32.cuh"

namespace {

using namespace graphit;

constexpr int kMaxW = 64;           // D and DV at most 64

// The key pass on the tensor cores (the design in the note above).
constexpr int kKT = 64;                  // keys per block
constexpr int kQT = 32;                  // queries per tile
constexpr int kLDT = kQT + 4;            // attn / ds tiles [kKT][kLDT]
constexpr int kLDP = kKT + 4;            // pe tile [kQT][kLDP]
constexpr int kNRC = 6;                  // row constants cq m ise qa beta c

constexpr int kLD64 = kMaxW + 4;         // rows of 64 floats, padded

struct KLayout {
  float *xs, *vws, *ring, *ats, *dss, *cks, *dgs, *kms, *red;
};

// one ring stage: xa [kQT][kLD64], g [kQT][kLD64], pe [kQT][kLDP],
// rc [6][kQT]
constexpr int kStage = kQT * (2 * kLD64 + kLDP) + kNRC * kQT;

__device__ __host__ inline size_t k_smem_floats() {
  return (size_t)2 * kKT * kLD64 + 2 * kStage + 2 * (size_t)kKT * kLDT +
         3 * kKT + 2 * kKT;
}

__device__ inline KLayout k_layout(float* smem) {
  KLayout l;
  l.xs = smem;                           // [kKT][kLD64] key tile (resident)
  l.vws = l.xs + kKT * kLD64;            // [kKT][kLD64] its values
  l.ring = l.vws + kKT * kLD64;          // 2 stages
  l.ats = l.ring + 2 * kStage;           // [kKT][kLDT] attn^T
  l.dss = l.ats + kKT * kLDT;            // [kKT][kLDT] ds^T
  l.cks = l.dss + kKT * kLDT;            // [kKT]
  l.dgs = l.cks + kKT;
  l.kms = l.dgs + kKT;
  l.red = l.kms + kKT;                   // [2][kKT] dck halves
  return l;
}

__global__ void __launch_bounds__(kThreads, 2)
flash_bwd_k_kernel(Operands op, float* __restrict__ dvw,
                   float* __restrict__ dck, float* __restrict__ dx_heads,
                   int H, int N, int D, int DV, float inv_sqrt) {
  extern __shared__ float smem[];
  const KLayout l = k_layout(smem);

  const int nk = (N + kKT - 1) / kKT;
  int bid = blockIdx.x;
  const int h = bid % H;
  bid /= H;
  const int k0 = (bid % nk) * kKT;
  const int b = bid / nk;
  const int tid = threadIdx.x;
  const int warp = tid / 32, g = tc::lane_g(), t = tc::lane_t();
  const int kr0 = 16 * (warp % 4);       // the warp's key strip
  const int wq = warp / 4;               // its query half / column half

  const size_t bh = (size_t)b * H + h;
  const float* xa_bh = op.xa + bh * N * D;
  const float* g_bh = op.g + bh * N * DV;
  const float* pe_b = op.pe ? op.pe + (size_t)b * N * N : nullptr;
  const float* const rows[kNRC] = {op.cq, op.m, op.ise, op.qa, op.beta,
                                   op.c};

  // 16-byte copies where every row allows them: each thread then stages
  // fixed chunks of rows of 64 floats, chunk i at row i / 16, column
  // 4 (i % 16), zero beyond the width and the ragged edge
  const bool vec_rows = tc::vec_ok(xa_bh, D, 0, 0, D) &&
                        tc::vec_ok(g_bh, DV, 0, 0, DV);
  bool vec_keys = N % 4 == 0 && (!pe_b || tc::vec_ok(pe_b, N, 0, k0, kKT));
  for (int j = 0; j < kNRC; ++j)
    vec_keys = vec_keys && tc::vec_ok(rows[j] + bh * N, 0, 0, 0, 4);

  // the query tile q0 into ring stage `s` (cp.async, one commit group)
  auto issue = [&](int q0, int s) {
    float* xst = l.ring + s * kStage;
    float* gst = xst + kQT * kLD64;
    float* pst = gst + kQT * kLD64;
    float* rst = pst + kQT * kLDP;
    if (vec_rows) {
      for (int i = tid; i < kQT * 16; i += kThreads) {
        const int r = i >> 4, c = (i & 15) * 4, q = q0 + r;
        tc::cp_async16(xst + r * kLD64 + c, xa_bh + (size_t)q * D + c,
                       q < N && c < D);
        tc::cp_async16(gst + r * kLD64 + c, g_bh + (size_t)q * DV + c,
                       q < N && c < DV);
      }
    } else {
      tc::stage_rows(xst, kLD64, xa_bh, D, q0, kQT, N, 0, D, D, tid,
                     kThreads);
      tc::stage_rows(gst, kLD64, g_bh, DV, q0, kQT, N, 0, DV, DV, tid,
                     kThreads);
    }
    if (vec_keys) {
      for (int i = tid; pe_b && i < kQT * kKT / 4; i += kThreads) {
        const int r = i >> 4, c = (i & 15) * 4, q = q0 + r;
        tc::cp_async16(pst + r * kLDP + c, pe_b + (size_t)q * N + k0 + c,
                       q < N && k0 + c < N);
      }
      if (tid < kNRC * kQT / 4) {
        const int j = tid / (kQT / 4), c = (tid % (kQT / 4)) * 4;
        tc::cp_async16(rst + j * kQT + c, rows[j] + bh * N + q0 + c,
                       q0 + c < N);
      }
    } else {
      if (pe_b)
        tc::stage_rows(pst, kLDP, pe_b, N, q0, kQT, N, k0, kKT, N, tid,
                       kThreads);
      for (int j = 0; j < kNRC; ++j)
        tc::stage_rows(rst + j * kQT, kQT, rows[j] + bh * N, 0, 0, 1, 1, q0,
                       kQT, N, tid, kThreads);
    }
    tc::cp_async_commit();
  };

  issue(0, 0);
  tc::stage_rows(l.xs, kLD64, op.x + (size_t)b * N * D, D, k0, kKT, N, 0, D,
                 D, tid, kThreads);
  tc::stage_rows(l.vws, kLD64, op.vw + bh * N * DV, DV, k0, kKT, N, 0, DV,
                 DV, tid, kThreads);
  tc::cp_async_commit();
  if (tid < kKT) {
    const int key = k0 + tid;
    const bool in = key < N;
    l.cks[tid] = in ? op.ck[bh * N + key] : 0.f;
    l.dgs[tid] = in ? (op.deg ? op.deg[(size_t)b * N + key] : 1.f) : 0.f;
    l.kms[tid] = in ? op.mask[(size_t)b * N + key] : 0.f;
  }
  const float c0h = op.c0[h];
  const int D8 = (D + 7) & ~7, DV8 = (DV + 7) & ~7;

  // the update products: warp (up, kh, ch) takes keys 32 kh .. + 31 (two
  // m-tiles) and columns 32 ch .. + 31 (four n-tiles) of dvw (up = 0) or
  // dx_h (up = 1); its accumulators are C fragments, keys 32 kh + 16 mt +
  // g (+8), columns 32 ch + 8 n + 2 t (+1)
  const int up = warp >> 2, kh = (warp >> 1) & 1, ch = warp & 1;
  const int w8 = up ? D8 : DV8;
  float acc[2][4][4] = {};
  RunSum colsum[2];

  const int nq = (N + kQT - 1) / kQT;
  for (int it = 0; it < nq; ++it) {
    const int q0 = it * kQT;
    tc::cp_async_wait_all();
    __syncthreads();  // tile `it` visible; every warp done with it - 1
    if (it + 1 < nq) issue(q0 + kQT, (it + 1) & 1);
    const float* xas = l.ring + (it & 1) * kStage;
    const float* gs = xas + kQT * kLD64;
    const float* pes = gs + kQT * kLD64;
    const float* rcs = pes + kQT * kLDP;

    // The warp's 16 keys x 16 queries: s^T as the forward's FMA chain
    // (graphit_tile.cuh's dot4) at the thread's C-fragment positions, keys
    // kr0 + g (+8) and queries 16 wq + 8 n + 2 t (+1), so that exp(s - m)
    // / se is the forward's own; ga^T = vw g^T on the tensor cores (2
    // n-tiles, K = DV). The two interleave, CUDA cores beside tensor cores.
    // Where DV rounds to 8 (the filtered layer's per-head values) ga is
    // one k-step, whose tensor-core rounding, summed over 2048 queries,
    // put dck at 1.61x the CPU's error (PERF.md): there ga is an FMA chain
    // too.
    float s[2][4] = {}, ga[2][4] = {}, tile[2] = {0.f, 0.f};
    const float* krow = l.xs + (kr0 + g) * kLD64;
    const float* qrow = xas + (16 * wq + 2 * t) * kLD64;
#pragma unroll
    for (int kk = 0; kk < kMaxW; kk += 8) {
      if (kk < DV8 && DV8 > 8) {
        const tc::FragA a = tc::load_a(l.vws, kLD64, kr0, kk);
#pragma unroll
        for (int n = 0; n < 2; ++n)
          tc::mma3(ga[n], a, tc::load_b_nk(gs, kLD64, 16 * wq + 8 * n, kk));
      }
      if (kk == 0 && DV8 == 8) {   // ga as an FMA chain
        const float* vrow = l.vws + (kr0 + g) * kLD64;
        const float* grow = gs + (16 * wq + 2 * t) * kLD64;
#pragma unroll
        for (int k = 0; k < 8; k += 4) {
          const float4 vv[2] = {ld4(vrow + k), ld4(vrow + 8 * kLD64 + k)};
#pragma unroll
          for (int n = 0; n < 2; ++n)
#pragma unroll
            for (int f = 0; f < 2; ++f) {
              const float4 gq = ld4(grow + (8 * n + f) * kLD64 + k);
#pragma unroll
              for (int e = 0; e < 2; ++e)
                ga[n][2 * e + f] = dot4(gq, vv[e], ga[n][2 * e + f]);
            }
        }
      }
      if (kk < D8) {
#pragma unroll
        for (int k = kk; k < kk + 8; k += 4) {
          const float4 kv[2] = {ld4(krow + k), ld4(krow + 8 * kLD64 + k)};
#pragma unroll
          for (int n = 0; n < 2; ++n)
#pragma unroll
            for (int f = 0; f < 2; ++f) {
              const float4 qv = ld4(qrow + (8 * n + f) * kLD64 + k);
#pragma unroll
              for (int e = 0; e < 2; ++e)
                s[n][2 * e + f] = dot4(qv, kv[e], s[n][2 * e + f]);
            }
        }
      }
    }
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kl = kr0 + g + 8 * (i >> 1);
        const int ql = 16 * wq + 8 * n + 2 * t + (i & 1);
        float d = 0.f, attn = 0.f;
        if (k0 + kl < N && q0 + ql < N) {
          const float pd = (pe_b ? pes[ql * kLDP + kl] : 1.f) * l.dgs[kl];
          d = grad_score(s[n][i], rcs[ql], l.cks[kl], c0h, inv_sqrt,
                         l.kms[kl], rcs[kQT + ql], rcs[2 * kQT + ql],
                         rcs[3 * kQT + ql], rcs[4 * kQT + ql],
                         rcs[5 * kQT + ql], pd, ga[n][i], attn);
        }
        tile[i >> 1] += d;
        l.ats[kl * kLDT + ql] = attn;
        l.dss[kl * kLDT + ql] = d;
      }
    colsum[0].add(tile[0], it);
    colsum[1].add(tile[1], it);
    __syncthreads();  // attn^T and ds^T of the tile complete

    // dvw[key, v] += sum_q attn^T[key, q] g[q, v] or dx_h[key, k] +=
    // sum_q ds^T[key, q] xa[q, k], K = the tile's 32 queries: the tile's
    // sum into a fresh partial (flash_fwd.cu's note on summation order);
    // each B fragment serves both m-tiles
    const float* at = up ? l.dss : l.ats;
    const float* bm = up ? xas : gs;
    float part[2][4][4] = {};
#pragma unroll
    for (int kk = 0; kk < kQT; kk += 8) {
      const tc::FragA a0 = tc::load_a(at, kLDT, 32 * kh, kk);
      const tc::FragA a1 = tc::load_a(at, kLDT, 32 * kh + 16, kk);
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const int c0 = 32 * ch + 8 * n;
        if (c0 < w8) {
          const tc::FragB bf = tc::load_b_kn(bm, kLD64, kk, c0);
          tc::mma3(part[0][n], a0, bf);
          tc::mma3(part[1][n], a1, bf);
        }
      }
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[mt][n][i] += part[mt][n][i];
  }

  // dck: each thread's column sums over its queries (tile by tile), then
  // the 4 lanes of its row (fixed xor order), then the two query halves in
  // order
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    float v = colsum[j].sum();
    v += __shfl_xor_sync(0xffffffffu, v, 1);
    v += __shfl_xor_sync(0xffffffffu, v, 2);
    if (t == 0) l.red[wq * kKT + kr0 + g + 8 * j] = v;
  }
  __syncthreads();
  if (tid < kKT && k0 + tid < N)
    dck[bh * N + k0 + tid] = l.red[tid] + l.red[kKT + tid];
  float* const out = up ? dx_heads : dvw;
  const int width = up ? D : DV;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = k0 + 32 * kh + 16 * mt + g + 8 * (i >> 1);
        const int col = 32 * ch + 8 * n + 2 * t + (i & 1);
        if (key < N && col < width)
          out[(bh * N + key) * width + col] = acc[mt][n][i];
      }
}

// dx[b, n, k] = sum_h dx_heads[b, h, n, k], heads added in order 0..H-1.
__global__ void head_sum_kernel(const float* __restrict__ dx_heads,
                                float* __restrict__ dx, int B, int H,
                                size_t ND) {
  const size_t total = (size_t)B * ND;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    const size_t b = i / ND, rest = i % ND;
    const float* src = dx_heads + b * H * ND + rest;
    float t = 0.f;
    for (int h = 0; h < H; ++h) t += src[h * ND];
    dx[i] = t;
  }
}

size_t smem_k() { return sizeof(float) * k_smem_floats(); }

bool bad_shape(int B, int H, int N, int D, int DV) {
  return B <= 0 || H <= 0 || N <= 0 || D <= 0 || D > kMaxW || DV <= 0 ||
         DV > kMaxW;
}

}  // namespace

extern "C" int feta_flash_bwd_q(const void* xa, const void* x, const void* cq,
                                const void* ck, const void* c0,
                                const void* vw, const void* pe,
                                const void* deg, const void* mask,
                                const void* g, const void* m, const void* ise,
                                const void* qa, const void* beta,
                                const void* c, void* dxa, void* dcq, int B,
                                int H, int N, int D, int DV, float inv_sqrt,
                                void* stream) {
  if (bad_shape(B, H, N, D, DV)) return (int)cudaErrorInvalidValue;
  return bwdq::launch<false>(
      operands(xa, x, cq, ck, c0, vw, pe, deg, mask, g, m, ise, qa, beta, c),
      (float*)dxa, (float*)dcq, B, H, N, D, DV, inv_sqrt,
      (cudaStream_t)stream);
}

// dx_heads is scratch of B*H*N*D floats that the caller allocates.
extern "C" int feta_flash_bwd_k(const void* xa, const void* x, const void* cq,
                                const void* ck, const void* c0,
                                const void* vw, const void* pe,
                                const void* deg, const void* mask,
                                const void* g, const void* m, const void* ise,
                                const void* qa, const void* beta,
                                const void* c, void* dvw, void* dck,
                                void* dx_heads, void* dx, int B, int H, int N,
                                int D, int DV, float inv_sqrt, void* stream) {
  if (bad_shape(B, H, N, D, DV)) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_k();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_k_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int nk = (N + kKT - 1) / kKT;
  flash_bwd_k_kernel<<<B * H * nk, kThreads, smem, (cudaStream_t)stream>>>(
      operands(xa, x, cq, ck, c0, vw, pe, deg, mask, g, m, ise, qa, beta, c),
      (float*)dvw, (float*)dck, (float*)dx_heads, H, N, D, DV, inv_sqrt);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t nd = (size_t)N * D;
  const size_t total = (size_t)B * nd;
  const int blocks = (int)((total + kThreads - 1) / kThreads);
  head_sum_kernel<<<blocks < 4096 ? blocks : 4096, kThreads, 0,
                    (cudaStream_t)stream>>>((const float*)dx_heads,
                                            (float*)dx, B, H, nd);
  return (int)cudaGetLastError();
}

extern "C" const char* feta_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
