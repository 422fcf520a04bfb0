// GraphiT attention modulation chain on precomputed scores, forward and
// backward, f32, for sm_90a.
//
// Replaces the TPU kernels feta_tmlr_tpu/ops/pallas/modulation.py
// `_fwd_kernel` and `_bwd_kernel` (both launched by `_pallas_call`). For
// one (graph b, head h, query row i) over the keys j < N:
//
//   s[j]   = kmask[j] > 0 ? scores[b,h,i,j] : -1e30
//   a[j]   = exp(s[j] - max s) / sum_j exp(s[j] - max s)
//   p[j]   = pe[b,i,j] * deg[b,j]            (either may be absent: 1)
//   u[j]   = a[j] * p[j]     denom = sum_j u[j]
//   safe   = |denom| > 1e-9 ? denom : 1      guard = (|denom| > 1e-9)
//   attn[j] = u[j] / safe * qmask[i] * kmask[j]
//
// and, given the cotangent g of attn, the gradient of the scores (pe, deg
// and the masks are data):
//
//   gm  = g * qmask[i] * kmask[j]        r = sum_j gm * u
//   du  = gm / safe - r / safe^2 * guard  (du = g where the guard is off)
//   da  = du * p     t = sum_j da * a     ds = a * (da - t)
//
// What bounds it on the H100: bytes. It does ~10 operations per score and
// moves 8 bytes (score in, attention out; 12 in the backward), far below the
// card's ~20 operations per byte in f32. The chain is row-local, so the
// design is one warp per (b, h, i) row: lanes stride the keys, and the row
// maximum and the three row sums are warp shuffles. Nothing is staged in
// shared memory and nothing depends on N, so any N works (the TPU's `_tile`
// grid and its VMEM budget have no counterpart). Each pass re-reads the row
// (N * 4 bytes) from L1; only the first read of a row reaches L2 or device
// memory, so the kernel reads each score and writes each output once. The
// pe row of (b, i) is read by the H warps of that row's heads, which run in
// adjacent blocks, so the H - 1 later reads hit L2.
//
// C interface (ctypes): pointers and the stream as void*, returns the
// cudaError_t of the launch.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr float kMaskedScore = -1e30f;
constexpr float kEps = 1e-9f;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// One query row: its pointers and the softmax statistics of its scores.
struct Row {
  const float* s;      // scores[b, h, i, :]
  const float* pe;     // pe[b, i, :] or nullptr
  const float* deg;    // deg[b, :] or nullptr
  const float* km;     // mask[b, :]
  float qm;            // mask[b, i]
  int N;
  float m, se;         // max and sum of exp of the masked scores

  __device__ float score(int j) const {
    return km[j] > 0.f ? s[j] : kMaskedScore;
  }
  __device__ float a(int j) const { return expf(score(j) - m) / se; }
  __device__ float p(int j) const {
    return (pe ? pe[j] : 1.f) * (deg ? deg[j] : 1.f);
  }
};

// Locates the warp's row; false when the warp has none (the last block).
__device__ __forceinline__ bool make_row(const float* scores, const float* pe,
                                         const float* deg, const float* mask,
                                         int B, int H, int N, size_t* row_out,
                                         Row* row) {
  const size_t r = (size_t)blockIdx.x * kWarps + threadIdx.x / 32;
  if (r >= (size_t)B * H * N) return false;
  const int i = (int)(r % N);
  const int b = (int)(r / N / H);
  const int lane = threadIdx.x % 32;
  row->s = scores + r * N;
  row->pe = pe ? pe + ((size_t)b * N + i) * N : nullptr;
  row->deg = deg ? deg + (size_t)b * N : nullptr;
  row->km = mask + (size_t)b * N;
  row->qm = row->km[i];
  row->N = N;
  float m = -INFINITY;
  for (int j = lane; j < N; j += 32) m = fmaxf(m, row->score(j));
  row->m = warp_max(m);
  float se = 0.f;
  for (int j = lane; j < N; j += 32) se += expf(row->score(j) - row->m);
  row->se = warp_sum(se);
  *row_out = r;
  return true;
}

__device__ __forceinline__ float row_denom(const Row& row, int lane) {
  float den = 0.f;
  for (int j = lane; j < row.N; j += 32) den += row.a(j) * row.p(j);
  return warp_sum(den);
}

__global__ void __launch_bounds__(kThreads)
modulation_fwd_kernel(const float* __restrict__ scores,
                      const float* __restrict__ pe,
                      const float* __restrict__ deg,
                      const float* __restrict__ mask,
                      float* __restrict__ out, int B, int H, int N) {
  Row row;
  size_t r;
  if (!make_row(scores, pe, deg, mask, B, H, N, &r, &row)) return;
  const int lane = threadIdx.x % 32;
  const float den = row_denom(row, lane);
  const float safe = fabsf(den) > kEps ? den : 1.f;
  float* out_row = out + r * N;
  for (int j = lane; j < N; j += 32)
    out_row[j] = row.a(j) * row.p(j) / safe * row.qm * row.km[j];
}

__global__ void __launch_bounds__(kThreads)
modulation_bwd_kernel(const float* __restrict__ scores,
                      const float* __restrict__ pe,
                      const float* __restrict__ deg,
                      const float* __restrict__ mask,
                      const float* __restrict__ g, float* __restrict__ ds,
                      int B, int H, int N) {
  Row row;
  size_t r;
  if (!make_row(scores, pe, deg, mask, B, H, N, &r, &row)) return;
  const int lane = threadIdx.x % 32;
  const float den = row_denom(row, lane);
  const bool on = fabsf(den) > kEps;
  const float safe = on ? den : 1.f;
  const float guard = on ? 1.f : 0.f;
  const float* g_row = g + r * N;
  float rs = 0.f;
  for (int j = lane; j < N; j += 32) {
    const float gm = g_row[j] * row.qm * row.km[j];
    rs += gm * (row.a(j) * row.p(j));
  }
  rs = warp_sum(rs);
  const float beta = (rs / (safe * safe)) * guard;
  float t = 0.f;
  for (int j = lane; j < N; j += 32) {
    const float a = row.a(j);
    const float du = g_row[j] * row.qm * row.km[j] / safe - beta;
    t += du * row.p(j) * a;
  }
  t = warp_sum(t);
  float* ds_row = ds + r * N;
  for (int j = lane; j < N; j += 32) {
    const float a = row.a(j);
    const float du = g_row[j] * row.qm * row.km[j] / safe - beta;
    ds_row[j] = a * (du * row.p(j) - t);
  }
}

int blocks(int B, int H, int N) {
  const size_t rows = (size_t)B * H * N;
  return (int)((rows + kWarps - 1) / kWarps);
}

}  // namespace

extern "C" int feta_modulation_fwd(const void* scores, const void* pe,
                                   const void* deg, const void* mask,
                                   void* out, int B, int H, int N,
                                   void* stream) {
  if (B <= 0 || H <= 0 || N <= 0) return (int)cudaErrorInvalidValue;
  modulation_fwd_kernel<<<blocks(B, H, N), kThreads, 0,
                          (cudaStream_t)stream>>>(
      (const float*)scores, (const float*)pe, (const float*)deg,
      (const float*)mask, (float*)out, B, H, N);
  return (int)cudaGetLastError();
}

extern "C" int feta_modulation_bwd(const void* scores, const void* pe,
                                   const void* deg, const void* mask,
                                   const void* g, void* ds, int B, int H,
                                   int N, void* stream) {
  if (B <= 0 || H <= 0 || N <= 0) return (int)cudaErrorInvalidValue;
  modulation_bwd_kernel<<<blocks(B, H, N), kThreads, 0,
                          (cudaStream_t)stream>>>(
      (const float*)scores, (const float*)pe, (const float*)deg,
      (const float*)mask, (const float*)g, (float*)ds, B, H, N);
  return (int)cudaGetLastError();
}

extern "C" const char* feta_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
