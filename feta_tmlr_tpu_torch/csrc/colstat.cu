// Detached attention column statistics, f32 (and bf16 operands), for
// sm_90a.
//
// Replaces the TPU kernel feta_tmlr_tpu/ops/pallas/flash_attention.py
// `_colstat_kernel` (launched by `_call_colstat`). From the row statistics
// (m, se, su) that the forward emitted it recomputes the normalised,
// masked attention of one (graph b, head h)
//
//   attn[i,j] = exp(s[i,j] - m[i]) / se[i] * pd[i,j] * qmask[i] / safe[i]
//               * kmask[j],      safe[i] = |su/se| > 1e-9 ? su/se : 1
//
// with s (graphit_tile.cuh) and pd = pe[i,j] * deg[j] as in the forward,
// and writes per key column j
//
//   colsum[j] = sum_i attn[i,j] * wq[i]      (wq absent: 1)
//   diag[j]   = attn[j,j]
//
// The FeTA coefficient head needs gcn_norm_directed(attn) summed over the
// source axis; two launches of this kernel (wq = 1, then wq = deg_in^-1/2)
// give it without an [N, N] tensor in device memory (glue in colstat.py).
// The second needs the first's column sums of every row, so the two
// cannot be one launch without a grid-wide barrier.
//
// What bounds it on the H100: the score's f32 FMAs, 2·N²·D flops per
// (b, h): 4.29 GFLOP at B=4, H=8, N=1024, D=64, 0.064 ms at 67 TFLOP/s;
// its bytes (each input read once, pe once per graph) take 0.02 ms. The
// score stays on the CUDA cores as the forwards' FMA chain
// (graphit_tile.cuh's dot4), so that exp(s - m) is the forward's own: m
// is exactly the maximum of these scores and se normalises them.
//
// Design: the key passes' geometry (flash_bwd.cu). One block of 8 warps
// per (b, 64-key tile, h), h fastest, so the H blocks that read one pe
// tile run together and find it in L2. The block's 64 key rows of x
// (stride 68 floats) stay resident in shared memory, each thread's keys'
// ck, deg and mask in registers; it loops over every 64-query tile
// itself, so each column sum is finished inside one block: no atomics,
// and a fixed summation order (results bit-identical run to run).
// cp.async stages each query tile into a two-stage ring while the
// previous tile computes: the xa_h rows, the pe rows pe[q, k0 .. k0 + 63]
// and the row statistics cq, m, se, su, the query mask and wq, 16 bytes a
// copy where the rows allow it. Warp w takes keys 32 (w % 2) .. + 31 (two
// m-tiles) and queries 16 (w / 2) .. + 15 of each tile and computes s^T at
// the mma C-fragment positions: lane 4 g + t holds keys g + 8 e (e < 4)
// and queries 8 n + 2 t + f (n, f < 2), 16 scores. The score is bound by
// shared-memory bandwidth, not by its FMAs: each 16-byte load takes about
// 4 cycles of the SM's shared-memory pipe, and a thread's tile issues 128
// of them for 1024 FMAs (the parent's 4x4 SIMT tile loaded 4 bytes per 2
// FMAs; on the H100 at B=4, N=1024 (kernel_ab.py), a 2-key x 4-query
// thread tile, 96 loads for 512 FMAs, ran 0.270 ms, this one 0.205, and
// 4 x 8, with 154 registers and one block an SM, 0.271). A warp whose keys or queries all lie past N skips
// its score (the ZINC batch's N = 48 pads 64-key tiles). Each lane derives
// 1/se and qmask/safe for one of its warp's 16 queries, and shuffles hand
// them on.
//
// attn is formed in registers, per score as in the plain version:
// e * (1/se) * (pe * deg) * (qmask/safe) * kmask. The column sum takes a
// fixed order: each thread's 4 queries of a tile (n, then f) into a fresh
// partial by FMA with wq, the tiles' partials in runs of 8
// (graphit::RunSum, as the key passes sum dck), then the 4 lanes of a key
// row (xor 1, then 2), then the block's four query groups in order. The
// diagonal is written by the one thread that holds (j, j). Ragged N: rows
// and keys beyond N contribute nothing and are not stored.
//
// Shared memory: 91,392 bytes (x 64 x 68, two stages of xa and pe 64 x 68
// each and six rows of 64 statistics, the diagonal and the groups' sums);
// `__launch_bounds__(256, 2)`: 128 registers with a 28-byte spill, two
// blocks an SM.
//
// Wide rows: at D over 64 (up to 128, the OGB molecular models' d_model)
// the kernel's kW = 128 instantiation stages the x and xa rows at 128
// floats (stride 132) and runs the score's chain over all D columns, the
// forwards' chain at that width; nothing else changes. Shared memory
// 140,544 bytes (one block an SM).
//
// bf16 operands (the bf16 compute policy, FETA_COMPUTE_DTYPE=bfloat16):
// `feta_colstat_bf16` takes xa and x in bf16 with pe and deg in bf16
// (FETA_BF16_MODULATION=1), `feta_colstat_bf16_f32pe` with pe and deg in
// float (=0); the statistics, wq and both outputs stay float. They
// replace the same TPU kernel under its bf16 operands (attn recomputed in
// float from a bf16 dot, flash_attention.py:82, :841-842). The bf16 tiles
// are staged into the float ones converted (mma_tf32.cuh's note), which
// halves their bytes; the score's chain then runs on bf16-exact values,
// the JAX kernel's bf16 dot with an f32 accumulator up to the order of
// the sum, and nothing after the staging changes.
//
// C interface (ctypes): pointers and the stream as void*, returns the
// cudaError_t of the launch.

#include <cuda_runtime.h>
#include <math.h>

#include "graphit_tile.cuh"
#include "mma_tf32.cuh"

namespace {

using namespace graphit;

constexpr int kMaxW = 64;                // rows of up to 64 floats
constexpr int kWideW = 128;              // the wide rows, D up to 128
constexpr int kKT = 64;                  // keys per block
constexpr int kLD64 = kMaxW + 4;         // rows of 64 floats, padded
// A thread's scores: keys g + 8 e (e < kEK) of its warp's key group and
// queries 8 n + 2 t + f (n < kNQ, f < 2) of its warp's query group, the
// C-fragment positions of kEK / 2 m-tiles by kNQ n-tiles.
constexpr int kEK = 4;
constexpr int kNQ = 2;
constexpr int kWarps = kThreads / 32;
constexpr int kKW = 8 * kEK;             // keys of a warp
constexpr int kKH = kKT / kKW;           // key groups of a block
constexpr int kQG = kWarps / kKH;        // query groups of a block
constexpr int kQW = 8 * kNQ;             // queries of a warp
constexpr int kQT = kQG * kQW;           // queries per tile
constexpr int kNRS = 6;                  // row statistics cq m se su qm wq
enum { kCq, kM, kSe, kSu, kQm, kWq };
static_assert(kKH * kKW == kKT && kKH * kQG == kWarps && kQW <= 32,
              "warp tiles must cover the block's keys and a query tile");

// rows of up to kW floats, padded
__host__ __device__ constexpr int ld(int kW) { return kW + 4; }

// one ring stage: xa [kQT][ld(kW)], pe [kQT][kLD64], rows [6][kQT]
template <int kW>
__host__ __device__ constexpr int stage_floats() {
  return kQT * (ld(kW) + kLD64) + kNRS * kQT;
}

template <int kW>
__host__ __device__ constexpr size_t smem_floats() {
  return (size_t)kKT * ld(kW) + 2 * stage_floats<kW>() + kKT + kQG * kKT;
}

// kW: the widest rows of xa and x, kMaxW or kWideW; TV, TM: the types of
// xa, x and of pe, deg (float, or bf16: the note on bf16 operands above)
template <int kW, class TV = float, class TM = float>
__global__ void __launch_bounds__(kThreads, 2)
colstat_kernel(const TV* __restrict__ xa, const TV* __restrict__ x,
               const float* __restrict__ cq, const float* __restrict__ ck,
               const float* __restrict__ c0, const TM* __restrict__ pe,
               const TM* __restrict__ deg, const float* __restrict__ mask,
               const float* __restrict__ m, const float* __restrict__ se,
               const float* __restrict__ su, const float* __restrict__ wq,
               float* __restrict__ colsum, float* __restrict__ diag, int H,
               int N, int D, float inv_sqrt) {
  constexpr int kLDX = ld(kW), kStage = stage_floats<kW>();
  extern __shared__ float smem[];
  float* xs = smem;                      // [kKT][kLDX] key rows (resident)
  float* ring = xs + kKT * kLDX;         // 2 stages
  float* diags = ring + 2 * kStage;      // [kKT]
  float* red = diags + kKT;              // [kQG][kKT] the groups' sums

  const int nk = (N + kKT - 1) / kKT;
  int bid = blockIdx.x;
  const int h = bid % H;
  bid /= H;
  const int k0 = (bid % nk) * kKT;
  const int b = bid / nk;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid / 32;
  const int g = tc::lane_g(), t = tc::lane_t();
  const int kr0 = kKW * (warp % kKH);    // the warp's key group
  const int wq0 = kQW * (warp / kKH);    // its queries of each tile
  const int wg = warp / kKH;             // its query group

  const size_t bh = (size_t)b * H + h;
  const TV* xa_bh = xa + bh * N * D;
  const TM* pe_b = pe ? pe + (size_t)b * N * N : nullptr;
  const float* const rows[kNRS] = {cq + bh * N, m + bh * N, se + bh * N,
                                   su + bh * N, mask + (size_t)b * N,
                                   wq ? wq + bh * N : nullptr};
  const int n_rows = wq ? kNRS : kNRS - 1;

  // 4-element copies where every row allows them, else one at a time
  const bool vec_xa = tc::vec_ok(xa_bh, D, 0, 0, D);
  bool vec_keys = N % 4 == 0 && (!pe_b || tc::vec_ok(pe_b, N, 0, k0, kKT));
  for (int j = 0; j < n_rows; ++j)
    vec_keys = vec_keys && tc::vec_ok(rows[j], 0, 0, 0, 4);

  // the query tile q0 into ring stage `s` (cp.async, one commit group)
  auto issue = [&](int q0, int s) {
    float* xst = ring + s * kStage;
    float* pst = xst + kQT * kLDX;
    float* rst = pst + kQT * kLD64;
    if (vec_xa) {
      constexpr int kVecs = kW / 4, kShift = kW == kWideW ? 5 : 4;
      for (int i = tid; i < kQT * kVecs; i += kThreads) {
        const int r = i >> kShift, c = (i & (kVecs - 1)) * 4, q = q0 + r;
        tc::copy4(xst + r * kLDX + c, xa_bh + (size_t)q * D + c,
                  q < N && c < D);
      }
    } else {
      tc::stage_rows(xst, kLDX, xa_bh, D, q0, kQT, N, 0, D, D, tid,
                     kThreads);
    }
    if (vec_keys) {
      for (int i = tid; pe_b && i < kQT * kKT / 4; i += kThreads) {
        const int r = i >> 4, c = (i & 15) * 4, q = q0 + r;
        tc::copy4(pst + r * kLD64 + c, pe_b + (size_t)q * N + k0 + c,
                  q < N && k0 + c < N);
      }
      if (tid < n_rows * kQT / 4) {
        const int j = tid / (kQT / 4), c = (tid % (kQT / 4)) * 4;
        tc::cp_async16(rst + j * kQT + c, rows[j] + q0 + c, q0 + c < N);
      }
    } else {
      if (pe_b)
        tc::stage_rows(pst, kLD64, pe_b, N, q0, kQT, N, k0, kKT, N, tid,
                       kThreads);
      for (int j = 0; j < n_rows; ++j)
        tc::stage_rows(rst + j * kQT, kQT, rows[j], 0, 0, 1, 1, q0, kQT, N,
                       tid, kThreads);
    }
    tc::cp_async_commit();
  };

  issue(0, 0);
  tc::stage_rows(xs, kLDX, x + (size_t)b * N * D, D, k0, kKT, N, 0, D, D,
                 tid, kThreads);
  tc::cp_async_commit();
  if (tid < kKT) diags[tid] = 0.f;
  // the thread's keys' constants: ck, deg and the key mask
  float ckr[kEK], dgr[kEK], kmr[kEK];
#pragma unroll
  for (int e = 0; e < kEK; ++e) {
    const int key = k0 + kr0 + g + 8 * e;
    const bool in = key < N;
    ckr[e] = in ? ck[bh * N + key] : 0.f;
    dgr[e] = in ? (deg ? tc::to_f32(deg[(size_t)b * N + key]) : 1.f) : 0.f;
    kmr[e] = in ? mask[(size_t)b * N + key] : 0.f;
  }
  const float c0h = c0[h];
  const int D8 = (D + 7) & ~7;
  const bool keys_in = k0 + kr0 < N;

  RunSum colsums[kEK];   // keys kr0 + g + 8 e
  const int nq = (N + kQT - 1) / kQT;
  for (int it = 0; it < nq; ++it) {
    const int q0 = it * kQT;
    tc::cp_async_wait_all();
    __syncthreads();  // tile `it` visible; every warp done with it - 1
    if (it + 1 < nq) issue(q0 + kQT, (it + 1) & 1);
    const float* xas = ring + (it & 1) * kStage;
    const float* pes = xas + kQT * kLDX;
    const float* rs = pes + kQT * kLD64;
    float tile[kEK] = {};
    if (keys_in && q0 + wq0 < N) {
      // lane l derives query wq0 + (l % kQW)'s 1/se and qmask/safe
      const int ql = wq0 + lane % kQW;
      float ise_l = 0.f, qa_l = 0.f;
      if (q0 + ql < N) {
        const float sev = rs[kSe * kQT + ql], suv = rs[kSu * kQT + ql];
        const float denom = suv / sev;
        const float safe = fabsf(denom) > kEps ? denom : 1.f;
        ise_l = 1.f / sev;
        qa_l = rs[kQm * kQT + ql] / safe;
      }
      // s^T as the forwards' FMA chain at the C-fragment positions: keys
      // kr0 + g + 8 e, queries wq0 + 8 n + 2 t + f
      float s[kNQ][kEK][2] = {};
      const float* krow = xs + (kr0 + g) * kLDX;
      const float* qrow = xas + (wq0 + 2 * t) * kLDX;
#pragma unroll
      for (int kk = 0; kk < kW; kk += 8) {
        if (kk < D8) {
#pragma unroll
          for (int k = kk; k < kk + 8; k += 4) {
            float4 kv[kEK];
#pragma unroll
            for (int e = 0; e < kEK; ++e) kv[e] = ld4(krow + 8 * e * kLDX + k);
#pragma unroll
            for (int n = 0; n < kNQ; ++n)
#pragma unroll
              for (int f = 0; f < 2; ++f) {
                const float4 qv = ld4(qrow + (8 * n + f) * kLDX + k);
#pragma unroll
                for (int e = 0; e < kEK; ++e)
                  s[n][e][f] = dot4(qv, kv[e], s[n][e][f]);
              }
          }
        }
      }
      // the thread's queries' constants, 8 n + 2 t + f
      float ise[kNQ][2], qa[kNQ][2], cqr[kNQ][2], mr[kNQ][2], wqr[kNQ][2];
#pragma unroll
      for (int n = 0; n < kNQ; ++n)
#pragma unroll
        for (int f = 0; f < 2; ++f) {
          const int ql = wq0 + 8 * n + 2 * t + f;
          ise[n][f] = __shfl_sync(0xffffffffu, ise_l, 8 * n + 2 * t + f);
          qa[n][f] = __shfl_sync(0xffffffffu, qa_l, 8 * n + 2 * t + f);
          cqr[n][f] = rs[kCq * kQT + ql];
          mr[n][f] = rs[kM * kQT + ql];
          wqr[n][f] = wq ? rs[kWq * kQT + ql] : 1.f;
        }
#pragma unroll
      for (int n = 0; n < kNQ; ++n)
#pragma unroll
        for (int e = 0; e < kEK; ++e)
#pragma unroll
          for (int f = 0; f < 2; ++f) {
            const int kl = kr0 + g + 8 * e;
            const int ql = wq0 + 8 * n + 2 * t + f;
            if (k0 + kl >= N || q0 + ql >= N) continue;
            const float v = score(s[n][e][f], cqr[n][f], ckr[e], c0h,
                                  inv_sqrt, kmr[e]);
            const float ex = expf(v - mr[n][f]);
            const float pd = (pe_b ? pes[ql * kLD64 + kl] : 1.f) * dgr[e];
            const float attn = ex * ise[n][f] * pd * qa[n][f] * kmr[e];
            tile[e] = fmaf(attn, wqr[n][f], tile[e]);
            if (q0 + ql == k0 + kl) diags[kl] = attn;  // the one holder
          }
    }
#pragma unroll
    for (int e = 0; e < kEK; ++e) colsums[e].add(tile[e], it);
  }

  // each thread's column sums over its queries (tile by tile, in runs),
  // then the 4 lanes of its key row (fixed xor order), then the query
  // groups in order
#pragma unroll
  for (int e = 0; e < kEK; ++e) {
    float v = colsums[e].sum();
    v += __shfl_xor_sync(0xffffffffu, v, 1);
    v += __shfl_xor_sync(0xffffffffu, v, 2);
    if (t == 0) red[wg * kKT + kr0 + g + 8 * e] = v;
  }
  __syncthreads();
  if (tid < kKT && k0 + tid < N) {
    float v = red[tid];
    for (int q = 1; q < kQG; ++q) v += red[q * kKT + tid];
    colsum[bh * N + k0 + tid] = v;
    diag[bh * N + k0 + tid] = diags[tid];
  }
}

// Launch at row width kW: one block per (b, 64-key tile, h).
template <int kW, class TV, class TM>
int launch(const void* xa, const void* x, const void* cq, const void* ck,
           const void* c0, const void* pe, const void* deg, const void* mask,
           const void* m, const void* se, const void* su, const void* wq,
           void* colsum, void* diag, int B, int H, int N, int D,
           float inv_sqrt, void* stream) {
  const size_t smem = sizeof(float) * smem_floats<kW>();
  cudaError_t err = cudaFuncSetAttribute(
      colstat_kernel<kW, TV, TM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int nk = (N + kKT - 1) / kKT;
  colstat_kernel<kW, TV, TM>
      <<<B * H * nk, kThreads, smem, (cudaStream_t)stream>>>(
      (const TV*)xa, (const TV*)x, (const float*)cq, (const float*)ck,
      (const float*)c0, (const TM*)pe, (const TM*)deg,
      (const float*)mask, (const float*)m, (const float*)se,
      (const float*)su, (const float*)wq, (float*)colsum, (float*)diag, H, N,
      D, inv_sqrt);
  return (int)cudaGetLastError();
}

template <class TV, class TM>
int run(const void* xa, const void* x, const void* cq, const void* ck,
        const void* c0, const void* pe, const void* deg, const void* mask,
        const void* m, const void* se, const void* su, const void* wq,
        void* colsum, void* diag, int B, int H, int N, int D, float inv_sqrt,
        void* stream) {
  if (B <= 0 || H <= 0 || N <= 0 || D <= 0 || D > kWideW)
    return (int)cudaErrorInvalidValue;
  return (D > kMaxW ? launch<kWideW, TV, TM> : launch<kMaxW, TV, TM>)(
      xa, x, cq, ck, c0, pe, deg, mask, m, se, su, wq, colsum, diag, B, H, N,
      D, inv_sqrt, stream);
}

}  // namespace

#define FETA_COLSTAT_ARGS                                                  \
  const void *xa, const void *x, const void *cq, const void *ck,           \
      const void *c0, const void *pe, const void *deg, const void *mask,   \
      const void *m, const void *se, const void *su, const void *wq,       \
      void *colsum, void *diag, int B, int H, int N, int D, float inv_sqrt, \
      void *stream
#define FETA_COLSTAT_CALL                                                  \
  xa, x, cq, ck, c0, pe, deg, mask, m, se, su, wq, colsum, diag, B, H, N, \
      D, inv_sqrt, stream

// float operands
extern "C" int feta_colstat(FETA_COLSTAT_ARGS) {
  return run<float, float>(FETA_COLSTAT_CALL);
}

// bf16 xa and x; bf16 pe and deg (FETA_BF16_MODULATION=1)
extern "C" int feta_colstat_bf16(FETA_COLSTAT_ARGS) {
  return run<tc::bf16, tc::bf16>(FETA_COLSTAT_CALL);
}

// bf16 xa and x; float pe and deg (FETA_BF16_MODULATION=0)
extern "C" int feta_colstat_bf16_f32pe(FETA_COLSTAT_ARGS) {
  return run<tc::bf16, float>(FETA_COLSTAT_CALL);
}

extern "C" const char* feta_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
