// Online-softmax GraphiT attention forward, f32, for sm_90a.
//
// Replaces the TPU kernel feta_tmlr_tpu/ops/pallas/flash_attention.py
// `_fwd_kernel` (launched by `_call_fwd`). For one (graph b, head h):
//
//   s[i,j]  = (xa_h[i]·x[j] + cq[i] + ck[j] + c0) * inv_sqrt,
//             -1e30 where key j is padding
//   m[i]    = max_j s[i,j]           e[i,j] = exp(s[i,j] - m[i])
//   pd[i,j] = pe[i,j] * deg[j]       (either may be absent: 1)
//   se[i]   = sum_j e                su[i]  = sum_j e*pd   (NO key mask)
//   out[i]  = qmask[i] * (sum_j e*pd*kmask[j] * vw[j]) / div[i]
//   div[i]  = |su/se| > 1e-9 ? su : se
//
// and emits out [B,H,N,DV] plus the row statistics m, se, su [B,H,N],
// which the column-statistics kernel (colstat.cu) consumes. The running
// (m, se, su) triple is rescaled by exp(m_old - m_new) per key tile, so no
// [N, N] tile ever reaches device memory.
//
// Summation order: each key tile's P·V goes into a fresh partial that is
// added to the rescaled accumulator once per tile, as se and su are. One
// f32 accumulator over all N keys in order rounds ~4x worse at N=2048
// (measured on the SBM model's layers, `chip_smoke.py --precision`).
//
// The kernel is fwd.cuh's body on the unfolded grid: one block per (b,
// 64-query tile, h), h fastest, in strips of 16 queries (strips.cuh); at
// D or DV over 64 (up to 128) its wide-row instantiation, one block per
// 64 value columns as well (fwd.cuh's note). Its
// score is the FMA chain that colstat.cu and the backward passes repeat bit
// for bit (graphit_tile.cuh's dot4); P·V runs on the tensor cores in
// error-compensated TF32 (mma_tf32.cuh). What bounds it, and the design's
// answer, are in fwd.cuh's note. The H blocks that read the same pe rows
// are adjacent in launch order, so the pe tile they share comes from L2
// (50 MB holds the whole [B, N, N] pe at B=8, N=1024).
//
// C interface (ctypes): pointers and the stream as void*, returns the
// cudaError_t of the launch.

#include <cuda_runtime.h>

#include "fwd.cuh"
#include "graphit_tile.cuh"

extern "C" int feta_flash_fwd(const void* xa, const void* x, const void* cq,
                              const void* ck, const void* c0, const void* vw,
                              const void* pe, const void* deg,
                              const void* mask, void* outh, void* m, void* se,
                              void* su, int B, int H, int N, int D, int DV,
                              float inv_sqrt, void* stream) {
  if (B <= 0 || H <= 0 || N <= 0 || D <= 0 || D > strips::kWideW ||
      DV <= 0 || DV > strips::kWideW)
    return (int)cudaErrorInvalidValue;
  const graphit::Operands op = graphit::operands(
      xa, x, cq, ck, c0, vw, pe, deg, mask, nullptr, nullptr, nullptr,
      nullptr, nullptr, nullptr);
  // rows of up to 64 floats, or the wide rows and their value chunks
  auto run = D > strips::kMaxW || DV > strips::kMaxW
                 ? fwd::launch<false, strips::kWideW>
                 : fwd::launch<false, strips::kMaxW>;
  return run(op, (float*)outh, (float*)m, (float*)se, (float*)su, B, H, N, D,
             DV, inv_sqrt, (cudaStream_t)stream);
}

extern "C" const char* feta_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
