// Float32 tile products on the H100's tensor cores, error-compensated
// ("3xTF32"), and the asynchronous staging that feeds them. Shared by the
// forwards' body fwd.cuh (P·V), the key passes of flash_bwd.cu and
// flash_hf.cu, the query passes' body bwd_q.cuh and fused_attention.cu.
//
// Arithmetic. `mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32` multiplies
// TF32 operands (8 explicit mantissa bits dropped to 10: about three decimal
// digits) into an f32 accumulator. One such product misses the float32
// accuracy that every check of this port holds the kernels to. So each f32
// operand a is split into
//
//   hi = cvt.rna.tf32.f32(a),   lo = cvt.rna.tf32.f32(a - hi)
//
// (a - hi is exact in f32), and each product a·b is taken as
//
//   lo_a·hi_b + hi_a·lo_b + hi_a·hi_b
//
// in that order, the small terms first, into the f32 accumulator; the
// dropped lo·lo term is below f32 rounding. This is CUTLASS's
// OpMultiplyAddFastF32 idea (cutlass/arch/mma_sm80.h), written out here: 3
// tensor-core products per f32 product. The card's TF32 peak is 495
// TFLOP/s, reached only by wgmma; mma.sync's m16n8k8 runs at about a
// quarter of it (measured, PERF.md), so 3xTF32 by mma.sync peaks near 41
// TFLOP/s of f32 products, below the 67 of f32 FMAs on CUDA cores; it
// wins because a tile product needs far fewer instructions and
// shared-memory reads than the FMA micro-tiles did.
//
// Fragments (PTX ISA, m16n8k8 .tf32): lane = 4 g + t (g < 8, t < 4).
//   A, 16 x 8, row-major:  a0 (g, t), a1 (g + 8, t), a2 (g, t + 4),
//                          a3 (g + 8, t + 4)
//   B, 8 x 8 (k x n):      b0 (t, g), b1 (t + 4, g)
//   C, 16 x 8 f32:         c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t),
//                          c3 (g + 8, 2t + 1)
// Tiles sit in shared memory with a padded row stride of 4 more than a
// multiple of 8 floats (68 for rows of 64): a row-major A load (and a B
// load from a tile stored [n][k]) then hits 32 distinct banks; a B load
// from a tile stored [k][n] hits each bank at most twice. The K edge: the
// columns from a width W up to W rounded to 8 are zero-filled in every
// staged tile, so a width that is not a multiple of 8 (D = 20, DV = 12)
// adds exact zeros.
//
// Staging: `cp.async` copies 16 bytes a thread where the source rows allow
// it (width and row stride multiples of 4 floats, 16-byte aligned base),
// else 4 bytes; rows beyond the ragged edge and the K-edge columns are
// zero-filled by the copy itself (src-size 0). A kernel stages tile t + 1
// into one half of a two-stage ring while it computes tile t from the
// other half.
//
// bf16 operands (the bf16 compute policy, FETA_COMPUTE_DTYPE=bfloat16).
// The attention kernels' bf16 instantiations stage a bf16 tile into the
// same float tile: `copy4` / `copy1` load 8 or 2 bytes, convert them to
// float and store them (a plain load and store where the float
// instantiation issues cp.async), so the global bytes halve and the tile
// code after the staging runs unchanged. Every operand of their tensor-core
// products is then bf16-exact (P, ds and attn are rounded to bf16 first,
// where the JAX kernels cast them): TF32's 10-bit mantissa holds a bf16
// value without loss, the lo term of `split` is zero, and one TF32 product
// (`mma1`) is the exact bf16 product with an f32 accumulator that 3xTF32
// would give, at a third of the tensor-core instructions.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tc {

struct Split {
  uint32_t hi, lo;
};

// The split, for finite x, in four instructions. cvt.rna.tf32.f32 is
// "add half a TF32 ulp (bit 12), clear the 13 low bits"; its inf/NaN test
// makes it three instructions on sm_90a, and the tensor cores ignore the 13
// low bits of a .tf32 operand anyway (CUTLASS's round_half_ulp_truncate).
// So hi and lo are handed to the mma as x + half an ulp; hi's low bits are
// cleared only to form x - hi. The mma sees exactly cvt.rna(x) and
// cvt.rna(x - cvt.rna(x)). The kernels' operands are finite.
__device__ __forceinline__ Split split(float x) {
  const uint32_t hi = __float_as_uint(x) + 0x1000u;
  const float lo = x - __uint_as_float(hi & 0xffffe000u);
  return Split{hi, __float_as_uint(lo) + 0x1000u};
}

// d += a·b for one TF32 m16n8k8 product
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d = a·b, into a fresh accumulator (C = 0)
__device__ __forceinline__ void mma_fresh(float (&d)[4],
                                          const uint32_t (&a)[4],
                                          const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %11, %12, %13};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]),
        "f"(0.f), "f"(0.f), "f"(0.f), "f"(0.f));
}

struct FragA {
  uint32_t hi[4], lo[4];
};
struct FragB {
  uint32_t hi[2], lo[2];
};

// d += a·b in 3xTF32: lo·hi, hi·lo, then hi·hi into a fresh fragment,
// which is added to d on the CUDA cores (IEEE round to nearest). The
// tensor cores' own f32 sum is not round-to-nearest: kept as a running sum
// in the mma's accumulator over many k-steps, it moved the key passes'
// gradients an order of magnitude further from float64 than the CPU's
// float32 does (`chip_smoke.py --precision`, PERF.md); with a fresh
// fragment for each k-step, they come near the CPU's. The backward passes
// do not take their score s from here: the forwards' row statistics m and
// se normalise exp(s - m) for their own FMA-chain score, and a score a few
// ulp off theirs skews its row's attn (dvw up to an order of magnitude
// further from float64, PERF.md), so the passes repeat that chain.
__device__ __forceinline__ void mma3(float (&d)[4], const FragA& a,
                                     const FragB& b) {
  float p[4];
  mma_fresh(p, a.lo, b.hi);
  mma(p, a.hi, b.lo);
  mma(p, a.hi, b.hi);
#pragma unroll
  for (int i = 0; i < 4; ++i) d[i] += p[i];
}

// d = a·b in 3xTF32 where d is fresh (zero): mma3 without the add, the
// same bits
__device__ __forceinline__ void mma3_fresh(float (&d)[4], const FragA& a,
                                           const FragB& b) {
  mma_fresh(d, a.lo, b.hi);
  mma(d, a.hi, b.lo);
  mma(d, a.hi, b.hi);
}

// d += a·b for bf16-exact operands: one TF32 product (hi·hi; the lo terms
// are zero, the note above) into a fresh fragment, added to d as mma3 adds
__device__ __forceinline__ void mma1(float (&d)[4], const FragA& a,
                                     const FragB& b) {
  float p[4];
  mma_fresh(p, a.hi, b.hi);
#pragma unroll
  for (int i = 0; i < 4; ++i) d[i] += p[i];
}

// d = a·b for bf16-exact operands where d is fresh (zero)
__device__ __forceinline__ void mma1_fresh(float (&d)[4], const FragA& a,
                                           const FragB& b) {
  mma_fresh(d, a.hi, b.hi);
}

// d (+)= a·b: one TF32 product where the operands are bf16-exact (kBf),
// else 3xTF32
template <bool kBf>
__device__ __forceinline__ void mma_add(float (&d)[4], const FragA& a,
                                        const FragB& b) {
  if constexpr (kBf)
    mma1(d, a, b);
  else
    mma3(d, a, b);
}

template <bool kBf>
__device__ __forceinline__ void mma_set(float (&d)[4], const FragA& a,
                                        const FragB& b) {
  if constexpr (kBf)
    mma1_fresh(d, a, b);
  else
    mma3_fresh(d, a, b);
}

__device__ __forceinline__ int lane_g() { return (threadIdx.x & 31) >> 2; }
__device__ __forceinline__ int lane_t() { return threadIdx.x & 3; }

// A rows row0 .. row0 + 15, columns k0 .. k0 + 7 of a row-major tile
__device__ __forceinline__ FragA load_a(const float* A, int ld, int row0,
                                        int k0) {
  const float* p = A + (row0 + lane_g()) * ld + k0 + lane_t();
  const float v[4] = {p[0], p[8 * ld], p[4], p[8 * ld + 4]};
  FragA f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const Split s = split(v[i]);
    f.hi[i] = s.hi;
    f.lo[i] = s.lo;
  }
  return f;
}

// A rows row0 .. row0 + 15, columns k0 .. k0 + 7 of the transpose of a tile
// stored [k][m], A(m, k) = At[k * ld + m] (fused_attention.cu's attn^T and
// ds^T); with ld 8 or 24 more than a multiple of 32, 32 distinct banks
__device__ __forceinline__ FragA load_a_t(const float* At, int ld, int row0,
                                          int k0) {
  const float* p = At + (k0 + lane_t()) * ld + row0 + lane_g();
  const float v[4] = {p[0], p[8], p[4 * ld], p[4 * ld + 8]};
  FragA f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const Split s = split(v[i]);
    f.hi[i] = s.hi;
    f.lo[i] = s.lo;
  }
  return f;
}

// B columns n0 .. n0 + 7, depth k0 .. k0 + 7, from a tile stored [n][k]
__device__ __forceinline__ FragB load_b_nk(const float* Bt, int ld, int n0,
                                           int k0) {
  const float* p = Bt + (n0 + lane_g()) * ld + k0 + lane_t();
  const Split s0 = split(p[0]), s1 = split(p[4]);
  return FragB{{s0.hi, s1.hi}, {s0.lo, s1.lo}};
}

// the same from a tile stored [k][n]
__device__ __forceinline__ FragB load_b_kn(const float* B, int ld, int k0,
                                           int n0) {
  const float* p = B + (k0 + lane_t()) * ld + n0 + lane_g();
  const Split s0 = split(p[0]), s1 = split(p[4 * ld]);
  return FragB{{s0.hi, s1.hi}, {s0.lo, s1.lo}};
}

// A product whose A is a C fragment's 16 x 8 tile (the forward's P, kept in
// registers): A's column t taken as the tile's column 2 t and column t + 4
// as 2 t + 1, so that a0..a3 = c0, c2, c1, c3. The depth of B must be
// permuted alike (`load_b_kn_pairs`); the product is the same sum.
__device__ __forceinline__ FragA frag_a_from_c(const float (&c)[4]) {
  const float v[4] = {c[0], c[2], c[1], c[3]};
  FragA f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const Split s = split(v[i]);
    f.hi[i] = s.hi;
    f.lo[i] = s.lo;
  }
  return f;
}

// B columns n0 .. n0 + 7 from a tile stored [k][n], depth k0 .. k0 + 7 in
// `frag_a_from_c`'s order: b0 row k0 + 2 t, b1 row k0 + 2 t + 1 (with a
// row stride of 68, 32 distinct banks each)
__device__ __forceinline__ FragB load_b_kn_pairs(const float* B, int ld,
                                                 int k0, int n0) {
  const float* p = B + (k0 + 2 * lane_t()) * ld + n0 + lane_g();
  const Split s0 = split(p[0]), s1 = split(p[ld]);
  return FragB{{s0.hi, s1.hi}, {s0.lo, s1.lo}};
}

__device__ __forceinline__ int round8(int w) { return (w + 7) & ~7; }

// ---------------------------------------------------------------- staging

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// wait until at most `kPending` of the thread's newest commit groups are
// still in flight
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// ------------------------------------------------------ bf16 operands

using bf16 = __nv_bfloat16;

template <class T>
__host__ __device__ constexpr bool is_bf16() {
  return sizeof(T) == 2;
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

// v rounded to the nearest bf16 (ties to even), as a float
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// one output element, rounded once where the output is bf16
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(bf16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// dst[0..3] = src[0..3] as float, or zeros where !valid (src is then not
// read): a 16-byte cp.async from float, an 8-byte load from bf16
__device__ __forceinline__ void copy4(float* dst, const float* src,
                                      bool valid) {
  cp_async16(dst, src, valid);
}
__device__ __forceinline__ void copy4(float* dst, const bf16* src,
                                      bool valid) {
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (valid) {
    const uint2 r = *reinterpret_cast<const uint2*>(src);
    v = make_float4(__uint_as_float(r.x << 16),
                    __uint_as_float(r.x & 0xffff0000u),
                    __uint_as_float(r.y << 16),
                    __uint_as_float(r.y & 0xffff0000u));
  }
  *reinterpret_cast<float4*>(dst) = v;
}

// dst[0] = src[0] as float, or zero where !valid
__device__ __forceinline__ void copy1(float* dst, const float* src,
                                      bool valid) {
  cp_async4(dst, src, valid);
}
__device__ __forceinline__ void copy1(float* dst, const bf16* src,
                                      bool valid) {
  *dst = valid ? __bfloat162float(*src) : 0.f;
}

// Whether `stage_rows` may copy 4 elements at a time from `src` (16 bytes
// of float, 8 of bf16).
template <class T>
__device__ __forceinline__ bool vec_ok(const T* src, size_t row_stride,
                                       size_t src_mat, int col0, int w) {
  return w % 4 == 0 && row_stride % 4 == 0 && src_mat % 4 == 0 &&
         col0 % 4 == 0 && reinterpret_cast<size_t>(src) % (4 * sizeof(T)) == 0;
}

// For each of `nmat` matrices m (source src + m * src_mat, destination
// dst + m * dst_mat): dst[r * ld + c] = src[(row0 + r) * row_stride +
// col0 + c] for r < rows and c < round8(w), zero where row0 + r >= n_rows,
// col0 + c >= n_cols or c >= w. Issued by threads tid = 0 .. nthreads - 1
// as cp.async (float; a bf16 src is converted by plain loads and stores,
// `copy4`), without a commit or a wait.
template <class T>
__device__ __forceinline__ void stage_rows(
    float* dst, int ld, const T* src, size_t row_stride, int row0,
    int rows, int n_rows, int col0, int w, int n_cols, int tid, int nthreads,
    int nmat = 1, size_t src_mat = 0, int dst_mat = 0) {
  const int w8 = round8(w);
  const int cols = n_cols - col0 < w ? n_cols - col0 : w;  // valid columns
  if (vec_ok(src, row_stride, src_mat, col0, w)) {
    const int per = w8 / 4, per_mat = rows * per, total = nmat * per_mat;
    for (int i = tid; i < total; i += nthreads) {
      const int m = i / per_mat, rest = i - m * per_mat, r = rest / per;
      const int c = (rest - r * per) * 4, row = row0 + r;
      float* d = dst + m * dst_mat + r * ld + c;
      const T* sp = src + m * src_mat + (size_t)row * row_stride + col0 + c;
      if (row < n_rows && c < cols && c + 4 > cols) {
        // a chunk across the column edge n_cols, one element at a time
        for (int u = 0; u < 4; ++u) copy1(d + u, sp + u, c + u < cols);
        continue;
      }
      const bool valid = row < n_rows && c < cols;
      copy4(d, valid ? sp : src, valid);
    }
  } else {
    const int per_mat = rows * w8, total = nmat * per_mat;
    for (int i = tid; i < total; i += nthreads) {
      const int m = i / per_mat, rest = i - m * per_mat, r = rest / w8;
      const int c = rest - r * w8, row = row0 + r;
      const bool valid = row < n_rows && c < cols;
      copy1(dst + m * dst_mat + r * ld + c,
            valid ? src + m * src_mat + (size_t)row * row_stride + col0 + c
                  : src,
            valid);
    }
  }
}

}  // namespace tc
