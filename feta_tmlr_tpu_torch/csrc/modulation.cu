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
// What bounds it on the H100: bytes. It does ~10 operations per cell and
// moves 8 bytes (score in, attention out; 12 with g in the backward), far
// below the card's ~20 f32 operations per byte. What the function needs is
// the score (and g) of each cell whose query and key are both real, read
// once; every output cell written once; pe, degree and the mask read once
// (`chip_smoke.modulation_cost`). The design moves that and nothing else,
// and keeps the chain between the loads and the stores short, because at
// the ZINC batch (B=128, H=8, N=48; 15 MB) the whole call is one wave and
// its time is a few memory latencies and the chain:
//
// * A row is read once into registers. A team of T threads (a power of
//   two) holds the row's keys, V groups of 4 a thread. Each score and g is
//   loaded once (16-byte loads, the groups consecutive across the team,
//   where N % 4 == 0 and the pointers are 16-byte aligned; otherwise
//   4-byte loads with the keys strided by T), its exp is taken once and
//   kept, and the output is written once.
// * Geometry by N, one templated body (`geometry`). Up to 128 keys: one
//   group a thread (V = 1), T the least power of two that covers the
//   groups, 128 / T rows to a block of 128 threads, reduced by xor
//   shuffles within the group of lanes (N = 48: T = 16). Past 128 keys:
//   V = 4 and T the least power of two with 16 * T >= N; a team of up to
//   32 threads is a group of lanes as above, a larger one (N up to 8192;
//   N = 2048: T = 128) a block of its own, the warps' sums added in warp
//   order through shared memory. Past 8192 keys the row does not fit
//   the registers: the streaming kernels, one warp a row walking it in
//   four passes through L1.
// * pd once per (b, i): a team keeps pe[b, i, :] * deg[b, :], the key mask
//   and qmask[i] in registers and loops over the H heads, as the TPU
//   kernel forms pd once per block and loops its heads over it, so pe,
//   degree and the masks cross device memory once, not H times. A ring of
//   D heads' rows is in flight (D = 4 at V = 1, else 2): head h + D - 1 is
//   loaded before head h is reduced, so a small grid waits about one
//   memory latency for its scores, not H.
// * Masked cells are not read. A row whose query is masked writes zeros; a
//   group of 4 keys that are all masked is neither loaded nor
//   exponentiated and writes zeros. The output there is exactly 0, as the
//   TPU kernel's is: the masks are 0 / 1, so a real query's own key is
//   real, its row maximum is a real score and a masked key's exp(-1e30 -
//   max) is exactly 0 (and a row whose keys are all masked has a masked
//   query).
// * The chain, rewritten for one pass over registers. a * p / denom = e * p
//   / sp with sp = sum e * p: the softmax's sum se cancels in the
//   renormalisation, so where it is on attn = e * p / sp * qmask, and
//   se = sum e only decides the guard (denom = sp / se) and serves the rows
//   where it is off (attn = e / se * p). Backward, where it is on, t =
//   sum da * a = r / safe - r * denom / safe^2 is 0 in exact arithmetic and
//   ds = attn * (gm - rho) with rho = sum gm * attn; where it is off, ds =
//   a * (gm * p - rho) with rho = sum gm * p * a, as written above. So the
//   reductions are the maximum, then se and sp together, then (backward)
//   rho. A thread adds its own terms in float32 (a group's four pairwise,
//   then the groups), the team adds sp in float64, and rho is summed in
//   float64 term by term (its terms have both signs): the outputs' error
//   from float64 is then that of e and of three roundings, about half the
//   float32 route's. The order is fixed, so runs are bit-identical. The
//   divisions by sp or se are IEEE-rounded quotients from one reciprocal a
//   row (`div_rn`), because the IEEE division is a subroutine with a
//   branch: twelve a thread and head took 40 % of the time at the ZINC
//   batch.
//
// C interface (ctypes): pointers and the stream as void*, returns the
// cudaError_t of the launch.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kMaskedScore = -1e30f;
constexpr float kEps = 1e-9f;
constexpr int kSmallBlock = 128;   // threads of a block of small-N teams
constexpr int kWideMax = 512;      // the largest team: N <= 16 * kWideMax
constexpr int kStreamWarps = 8;    // rows of a block of the streaming kernels

struct Args {
  const float* scores;
  const float* pe;     // pe[b, :, :] or nullptr
  const float* deg;    // deg[b, :] or nullptr
  const float* mask;
  const float* g;      // the backward's cotangent; nullptr forward
  float* out;          // attn (forward) or d scores (backward)
  int B, H, N, T;
};

// The key of element q of group v of team thread t.
template <bool kVec>
__device__ __forceinline__ int key_of(int v, int q, int t, int T) {
  return kVec ? 4 * (v * T + t) + q : (4 * v + q) * T + t;
}

// The threads that hold one row: a group of T lanes of a warp (kWide
// false, T <= 32) or a block of T = 32 * W threads (kWide). Reductions end
// with the same value in every thread of the team: xor shuffles within the
// group (a warp when wide), then the W warps' values in warp order.
template <bool kWide>
struct Team {
  int T;
  unsigned lanes;      // the group's lanes (shuffle mask)
  double* red;         // wide: shared [2 slots][kWideMax / 32 warps][2]
  int slot;

  template <class F>
  __device__ __forceinline__ F lanes_sum(F v) const {
    for (int off = (kWide ? 32 : T) >> 1; off > 0; off >>= 1)
      v += __shfl_xor_sync(lanes, v, off);
    return v;
  }

  // Each warp's (a, b) into shared memory (a float is exact as a double);
  // the slots alternate, so one barrier a reduction suffices.
  __device__ __forceinline__ const double* publish(double a, double b) {
    double* r = red + slot * 2 * (kWideMax / 32);
    if (threadIdx.x % 32 == 0) {
      r[2 * (threadIdx.x / 32)] = a;
      r[2 * (threadIdx.x / 32) + 1] = b;
    }
    __syncthreads();
    slot ^= 1;
    return r;
  }

  __device__ __forceinline__ float max(float v) {
    for (int off = (kWide ? 32 : T) >> 1; off > 0; off >>= 1)
      v = fmaxf(v, __shfl_xor_sync(lanes, v, off));
    if (kWide) {
      const double* r = publish(v, 0.0);
      v = (float)r[0];
      for (int w = 1; w < T / 32; ++w) v = fmaxf(v, (float)r[2 * w]);
    }
    return v;
  }

  __device__ __forceinline__ void sum(float& f, double& d) {
    f = lanes_sum(f);
    d = lanes_sum(d);
    if (kWide) {
      const double* r = publish(f, d);
      f = (float)r[0];
      d = r[1];
      for (int w = 1; w < T / 32; ++w) {
        f += (float)r[2 * w];
        d += r[2 * w + 1];
      }
    }
  }

  __device__ __forceinline__ void sum(double& d) {
    d = lanes_sum(d);
    if (kWide) {
      const double* r = publish(d, 0.0);
      d = r[0];
      for (int w = 1; w < T / 32; ++w) d += r[2 * w];
    }
  }
};

// Bit 4 * v + q of `live`: the element's key is real (kmask > 0).
__device__ __forceinline__ bool bit(unsigned live, int v, int q) {
  return (live >> (4 * v + q)) & 1u;
}

__device__ __forceinline__ bool group_live(unsigned live, int v) {
  return (live >> (4 * v)) & 0xFu;
}

// One row of a [.., N] tensor into x; elements of masked keys are not read.
template <int V, bool kVec>
__device__ __forceinline__ void load_row(float (&x)[V][4],
                                         const float* __restrict__ row,
                                         unsigned live, int t, int T) {
#pragma unroll
  for (int v = 0; v < V; ++v) {
    if (kVec) {
      float4 f = make_float4(0.f, 0.f, 0.f, 0.f);
      if (group_live(live, v))
        f = __ldg(reinterpret_cast<const float4*>(row) + v * T + t);
      x[v][0] = f.x; x[v][1] = f.y; x[v][2] = f.z; x[v][3] = f.w;
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q)
        x[v][q] = bit(live, v, q) ? __ldg(row + key_of<false>(v, q, t, T))
                                  : 0.f;
    }
  }
}

// x into one row of the output; elements past N are not written.
template <int V, bool kVec>
__device__ __forceinline__ void store_row(float* __restrict__ row,
                                          const float (&x)[V][4], int t,
                                          int T, int N) {
#pragma unroll
  for (int v = 0; v < V; ++v) {
    if (kVec) {
      if (v * T + t < N / 4)
        reinterpret_cast<float4*>(row)[v * T + t] =
            make_float4(x[v][0], x[v][1], x[v][2], x[v][3]);
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int j = key_of<false>(v, q, t, T);
        if (j < N) row[j] = x[v][q];
      }
    }
  }
}

// a / b rounded to nearest, from y = __frcp_rn(b) (Markstein's theorem:
// with y the correctly rounded reciprocal, the remainder a - q * b of
// q = a * y is exact and q + r * y rounds to a / b): three instructions in
// place of the IEEE division's subroutine and its branch.
__device__ __forceinline__ float div_rn(float a, float b, float y) {
  const float q = __fmul_rn(a, y);
  return fmaf(fmaf(-q, b, a), y, q);
}

// A thread's partial sum of its elements: the four of a group pairwise,
// then the groups in order.
template <int V>
__device__ __forceinline__ float thread_sum(const float (&x)[V][4]) {
  float s = (x[0][0] + x[0][1]) + (x[0][2] + x[0][3]);
#pragma unroll
  for (int v = 1; v < V; ++v) s += (x[v][0] + x[v][1]) + (x[v][2] + x[v][3]);
  return s;
}

// One head of one team's query row: x holds the scores (g in gx,
// backward) of the thread's keys and becomes the output.
template <int V, bool kWide, bool kBwd>
__device__ __forceinline__ void head_row(Team<kWide>& team, float (&x)[V][4],
                                         float (&gx)[V][4],
                                         const float (&p)[V][4],
                                         unsigned live, float qm) {
  float m = kMaskedScore;
#pragma unroll
  for (int v = 0; v < V; ++v)
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (bit(live, v, q)) m = fmaxf(m, x[v][q]);
  m = team.max(m);

  // e * p, recomputed below; products that feed a sum are __fmul_rn, which
  // is never contracted into an FMA, so every build rounds them alike
  float ep[V][4];
#pragma unroll
  for (int v = 0; v < V; ++v)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      x[v][q] = bit(live, v, q) ? expf(x[v][q] - m) : 0.f;
      ep[v][q] = __fmul_rn(x[v][q], p[v][q]);
    }
  float se = thread_sum(x);
  double sp = thread_sum(ep);
  team.sum(se, sp);
  const float spf = (float)sp;
  const bool on = fabsf(spf) > kEps * se;          // |sp / se| > eps
  // w = attn = e * p / sp where the renormalisation is on, a = e / se
  // where it is off
  const float div = on ? spf : se, y = __frcp_rn(div);

  if (!kBwd) {
#pragma unroll
    for (int v = 0; v < V; ++v)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float w = on ? div_rn(__fmul_rn(x[v][q], p[v][q]), div, y)
                           : div_rn(x[v][q], div, y) * p[v][q];
        x[v][q] = bit(live, v, q) ? w * qm : 0.f;
      }
    return;
  }
  // c = gm (on) or gm * p (off): ds = w * (c - sum c * w)
  double rho = 0.0;
#pragma unroll
  for (int v = 0; v < V; ++v)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float gm = __fmul_rn(gx[v][q], qm);
      const float w =
          div_rn(on ? __fmul_rn(x[v][q], p[v][q]) : x[v][q], div, y);
      const float c = on ? gm : __fmul_rn(gm, p[v][q]);
      x[v][q] = w;
      gx[v][q] = c;
      rho += (double)(c * w);
    }
  team.sum(rho);
  const float rhof = (float)rho;
#pragma unroll
  for (int v = 0; v < V; ++v)
#pragma unroll
    for (int q = 0; q < 4; ++q)
      x[v][q] = bit(live, v, q) ? x[v][q] * (gx[v][q] - rhof) : 0.f;
}

// Heads in flight a thread: the loads of D heads are issued before the
// first is reduced, so a small grid waits about one memory latency, not H.
template <int V>
constexpr int kDepth = V == 1 ? 4 : 2;

// The forward (kBwd false) or the backward of one team's query row, for
// every head: V groups of 4 keys a thread, a team of a.T threads.
template <int V, bool kWide, bool kVec, bool kBwd>
__global__ void __launch_bounds__(kWide ? kWideMax : kSmallBlock,
                                  kWide ? 1 : 4)
modulation_kernel(const Args a) {
  constexpr int D = kDepth<V>;
  __shared__ double red[kWide ? 2 * 2 * (kWideMax / 32) : 1];
  const int T = a.T, N = a.N;
  Team<kWide> team{T, 0xffffffffu, red, 0};
  int t;
  long long row;
  if (kWide) {
    t = threadIdx.x;
    row = blockIdx.x;
  } else {
    const int lane = threadIdx.x % 32;
    t = lane & (T - 1);
    row = ((long long)blockIdx.x * kSmallBlock + threadIdx.x) / T;
    if (T < 32) team.lanes = ((1u << T) - 1u) << (lane & ~(T - 1));
    if (row >= (long long)a.B * N) return;   // the whole team
  }
  const int b = (int)(row / N), i = (int)(row % N);
  const float* km = a.mask + (size_t)b * N;
  const float qm = km[i];
  const size_t plane = (size_t)N * N;
  const size_t row0 = ((size_t)b * a.H * N + i) * N;   // head 0's row

  if (qm == 0.f) {                                     // a masked query
    float zero[V][4] = {};
    for (int h = 0; h < a.H; ++h)
      store_row<V, kVec>(a.out + row0 + h * plane, zero, t, T, N);
    return;
  }

  // The key mask and pd = pe[b, i, :] * deg[b, :] of this thread's keys,
  // kept over the heads.
  unsigned live = 0;
  float p[V][4];
  const float* pe_row = a.pe ? a.pe + ((size_t)b * N + i) * N : nullptr;
  const float* deg_row = a.deg ? a.deg + (size_t)b * N : nullptr;
#pragma unroll
  for (int v = 0; v < V; ++v) {
    float k4[4] = {0.f, 0.f, 0.f, 0.f};
    if (kVec) {
      if (v * T + t < N / 4) {
        const float4 f = __ldg(reinterpret_cast<const float4*>(km) + v * T + t);
        k4[0] = f.x; k4[1] = f.y; k4[2] = f.z; k4[3] = f.w;
      }
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int j = key_of<false>(v, q, t, T);
        if (j < N) k4[q] = __ldg(km + j);
      }
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) live |= (k4[q] > 0.f ? 1u : 0u) << (4 * v + q);
  }
  float pe4[V][4], dg4[V][4];
  if (pe_row) load_row<V, kVec>(pe4, pe_row, live, t, T);
  if (deg_row) load_row<V, kVec>(dg4, deg_row, live, t, T);
#pragma unroll
  for (int v = 0; v < V; ++v) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      float pd = 1.f;
      if (pe_row) pd *= pe4[v][q];
      if (deg_row) pd *= dg4[v][q];
      p[v][q] = bit(live, v, q) ? pd : 0.f;
    }
  }

  // A ring of D heads' rows (and g): head h in slot h % D; before head h
  // is reduced, head h + D - 1 is loaded into the slot head h - 1 left.
  float x[D][V][4], gx[D][V][4];
#pragma unroll
  for (int k = 0; k < D - 1; ++k) {
    if (k < a.H) {
      load_row<V, kVec>(x[k], a.scores + row0 + k * plane, live, t, T);
      if (kBwd) load_row<V, kVec>(gx[k], a.g + row0 + k * plane, live, t, T);
    }
  }
  for (int h0 = 0; h0 < a.H; h0 += D) {
#pragma unroll
    for (int k = 0; k < D; ++k) {
      const int h = h0 + k;
      if (h >= a.H) break;
      const int hn = h + D - 1, slot = (k + D - 1) % D;
      if (hn < a.H) {
        load_row<V, kVec>(x[slot], a.scores + row0 + hn * plane, live, t, T);
        if (kBwd)
          load_row<V, kVec>(gx[slot], a.g + row0 + hn * plane, live, t, T);
      }
      head_row<V, kWide, kBwd>(team, x[k], gx[k], p, live, qm);
      store_row<V, kVec>(a.out + row0 + h * plane, x[k], t, T, N);
    }
  }
}

// ---------------------------------------------------------- streaming
// Rows past 16 * kWideMax keys: one warp per (b, h, i) row, the lanes
// striding the keys, each pass re-reading the row (N * 4 bytes) from L1.

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
__device__ __forceinline__ bool make_row(const Args& a, size_t* row_out,
                                         Row* row) {
  const int N = a.N;
  const size_t r = (size_t)blockIdx.x * kStreamWarps + threadIdx.x / 32;
  if (r >= (size_t)a.B * a.H * N) return false;
  const int i = (int)(r % N);
  const int b = (int)(r / N / a.H);
  const int lane = threadIdx.x % 32;
  row->s = a.scores + r * N;
  row->pe = a.pe ? a.pe + ((size_t)b * N + i) * N : nullptr;
  row->deg = a.deg ? a.deg + (size_t)b * N : nullptr;
  row->km = a.mask + (size_t)b * N;
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

__global__ void __launch_bounds__(32 * kStreamWarps)
modulation_fwd_stream(const Args a) {
  Row row;
  size_t r;
  if (!make_row(a, &r, &row)) return;
  const int lane = threadIdx.x % 32;
  const float den = row_denom(row, lane);
  const float safe = fabsf(den) > kEps ? den : 1.f;
  float* out_row = a.out + r * a.N;
  for (int j = lane; j < a.N; j += 32)
    out_row[j] = row.a(j) * row.p(j) / safe * row.qm * row.km[j];
}

__global__ void __launch_bounds__(32 * kStreamWarps)
modulation_bwd_stream(const Args a) {
  Row row;
  size_t r;
  if (!make_row(a, &r, &row)) return;
  const int lane = threadIdx.x % 32;
  const float den = row_denom(row, lane);
  const bool on = fabsf(den) > kEps;
  const float safe = on ? den : 1.f;
  const float guard = on ? 1.f : 0.f;
  const float* g_row = a.g + r * a.N;
  float rs = 0.f;
  for (int j = lane; j < a.N; j += 32) {
    const float gm = g_row[j] * row.qm * row.km[j];
    rs += gm * (row.a(j) * row.p(j));
  }
  rs = warp_sum(rs);
  const float beta = (rs / (safe * safe)) * guard;
  float t = 0.f;
  for (int j = lane; j < a.N; j += 32) {
    const float aj = row.a(j);
    const float du = g_row[j] * row.qm * row.km[j] / safe - beta;
    t += du * row.p(j) * aj;
  }
  t = warp_sum(t);
  float* ds_row = a.out + r * a.N;
  for (int j = lane; j < a.N; j += 32) {
    const float aj = row.a(j);
    const float du = g_row[j] * row.qm * row.km[j] / safe - beta;
    ds_row[j] = aj * (du * row.p(j) - t);
  }
}

// ------------------------------------------------------------- launch

// The team: up to 128 keys (32 groups of 4), one group a thread (V = 1);
// past that, four (V = 4). T is the least power of two of threads that
// covers the groups, so that a small grid has threads and loads enough.
void geometry(int N, int* T, int* V) {
  const int groups = (N + 3) / 4;
  *V = groups <= 32 ? 1 : 4;
  int t = 1;
  while (t * *V < groups) t *= 2;
  *T = t;
}

template <int V, bool kWide, bool kVec, bool kBwd>
void launch(const Args& a, cudaStream_t stream) {
  if (kWide) {
    modulation_kernel<V, kWide, kVec, kBwd><<<a.B * a.N, a.T, 0, stream>>>(a);
  } else {
    const long long threads = (long long)a.B * a.N * a.T;
    const int blocks = (int)((threads + kSmallBlock - 1) / kSmallBlock);
    modulation_kernel<V, kWide, kVec, kBwd><<<blocks, kSmallBlock, 0,
                                              stream>>>(a);
  }
}

template <bool kVec, bool kBwd>
void launch_vec(const Args& a, int V, cudaStream_t stream) {
  const bool wide = a.T > 32;
  if (wide) launch<4, true, kVec, kBwd>(a, stream);
  if (!wide && V == 1) launch<1, false, kVec, kBwd>(a, stream);
  if (!wide && V == 4) launch<4, false, kVec, kBwd>(a, stream);
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15u) == 0; }

template <bool kBwd>
int run(Args a, cudaStream_t stream) {
  if (a.B <= 0 || a.H <= 0 || a.N <= 0) return (int)cudaErrorInvalidValue;
  int V;
  geometry(a.N, &a.T, &V);
  if (a.T > kWideMax) {
    const size_t rows = (size_t)a.B * a.H * a.N;
    const int blocks = (int)((rows + kStreamWarps - 1) / kStreamWarps);
    if (kBwd)
      modulation_bwd_stream<<<blocks, 32 * kStreamWarps, 0, stream>>>(a);
    else
      modulation_fwd_stream<<<blocks, 32 * kStreamWarps, 0, stream>>>(a);
    return (int)cudaGetLastError();
  }
  const bool vec = a.N % 4 == 0 && aligned16(a.scores) && aligned16(a.out)
                   && aligned16(a.pe) && aligned16(a.deg)
                   && aligned16(a.mask) && aligned16(a.g);
  if (vec)
    launch_vec<true, kBwd>(a, V, stream);
  else
    launch_vec<false, kBwd>(a, V, stream);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int feta_modulation_fwd(const void* scores, const void* pe,
                                   const void* deg, const void* mask,
                                   void* out, int B, int H, int N,
                                   void* stream) {
  const Args a{(const float*)scores, (const float*)pe, (const float*)deg,
               (const float*)mask, nullptr, (float*)out, B, H, N, 0};
  return run<false>(a, (cudaStream_t)stream);
}

extern "C" int feta_modulation_bwd(const void* scores, const void* pe,
                                   const void* deg, const void* mask,
                                   const void* g, void* ds, int B, int H,
                                   int N, void* stream) {
  const Args a{(const float*)scores, (const float*)pe, (const float*)deg,
               (const float*)mask, (const float*)g, (float*)ds, B, H, N, 0};
  return run<true>(a, (cudaStream_t)stream);
}

extern "C" const char* feta_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
