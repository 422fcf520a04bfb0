// Online-softmax GraphiT attention forward, f32 (and bf16 operands), for
// sm_90a.
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
// bf16 operands (the bf16 compute policy, FETA_COMPUTE_DTYPE=bfloat16):
// `feta_flash_fwd_bf16` takes xa, x and vw in bf16 with pe and deg in bf16
// (FETA_BF16_MODULATION=1, the default), `feta_flash_fwd_bf16_f32pe` with
// pe and deg in float (FETA_BF16_MODULATION=0); outh is bf16, m, se, su
// float. They replace the same TPU kernel under its bf16 operands
// (`_fwd_kernel`'s bf16 dots with f32 accumulators and P cast to vw's
// dtype, flash_attention.py:82, :124-125) and run fwd.cuh's bf16
// instantiation (its note says what changes: the staging converts, P is
// rounded to bf16, P·V is one exact TF32 product).
//
// C interface (ctypes): pointers and the stream as void*, returns the
// cudaError_t of the launch.

#include <cuda_runtime.h>

#include "fwd.cuh"
#include "graphit_tile.cuh"

namespace {

// The unfolded forward at TV (xa, x, vw, outh) and TM (pe, deg): rows of
// up to 64 floats, or the wide rows and their value chunks.
template <class TV, class TM>
int run_fwd(const void* xa, const void* x, const void* cq, const void* ck,
            const void* c0, const void* vw, const void* pe, const void* deg,
            const void* mask, void* outh, void* m, void* se, void* su, int B,
            int H, int N, int D, int DV, float inv_sqrt, void* stream) {
  if (B <= 0 || H <= 0 || N <= 0 || D <= 0 || D > strips::kWideW ||
      DV <= 0 || DV > strips::kWideW)
    return (int)cudaErrorInvalidValue;
  const graphit::OperandsT<TV, TM> op = graphit::operands<TV, TM>(
      xa, x, cq, ck, c0, vw, pe, deg, mask, nullptr, nullptr, nullptr,
      nullptr, nullptr, nullptr);
  auto run = D > strips::kMaxW || DV > strips::kMaxW
                 ? fwd::launch<false, strips::kWideW, TV, TM>
                 : fwd::launch<false, strips::kMaxW, TV, TM>;
  return run(op, (TV*)outh, (float*)m, (float*)se, (float*)su, B, H, N, D,
             DV, inv_sqrt, (cudaStream_t)stream);
}

}  // namespace

#define FETA_FWD_ARGS                                                     \
  const void *xa, const void *x, const void *cq, const void *ck,          \
      const void *c0, const void *vw, const void *pe, const void *deg,    \
      const void *mask, void *outh, void *m, void *se, void *su, int B,   \
      int H, int N, int D, int DV, float inv_sqrt, void *stream
#define FETA_FWD_CALL \
  xa, x, cq, ck, c0, vw, pe, deg, mask, outh, m, se, su, B, H, N, D, DV, \
      inv_sqrt, stream

// float operands
extern "C" int feta_flash_fwd(FETA_FWD_ARGS) {
  return run_fwd<float, float>(FETA_FWD_CALL);
}

// bf16 xa, x, vw and outh; bf16 pe and deg (FETA_BF16_MODULATION=1)
extern "C" int feta_flash_fwd_bf16(FETA_FWD_ARGS) {
  return run_fwd<tc::bf16, tc::bf16>(FETA_FWD_CALL);
}

// bf16 xa, x, vw and outh; float pe and deg (FETA_BF16_MODULATION=0)
extern "C" int feta_flash_fwd_bf16_f32pe(FETA_FWD_ARGS) {
  return run_fwd<tc::bf16, float>(FETA_FWD_CALL);
}

extern "C" const char* feta_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
