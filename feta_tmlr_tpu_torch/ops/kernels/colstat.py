"""Detached attention column statistics for the FeTA coefficient head.

Kernel: `csrc/colstat.cu`, the H100 counterpart of the TPU kernel
`feta_tmlr_tpu/ops/pallas/flash_attention.py::_colstat_kernel`. It
recomputes attention tiles from the forward kernel's row statistics and
sums columns weighted per query row; its source note says what bounds it
(the score's f32 FMAs, 2·B·H·N²·D flops per launch) and how the design
answers that (the key passes' geometry: one block per key tile loops over
every query tile through a cp.async ring, the score as the forwards' FMA
chain at the mma C-fragment positions; no atomics, sums in a fixed
order).

`colstat` is the wrapper: on a CUDA tensor it launches the kernel and
counts the launch in `colstat.launches`; on a CPU tensor it runs
`colstat_plain`. `attention_column_gcn_sums` is the glue between the two
launches that yields gcn_norm_directed(attn).sum(source axis).
"""

from __future__ import annotations

import torch

from feta_tmlr_tpu_torch.ops.kernels import build
from feta_tmlr_tpu_torch.ops.kernels.common import (
    EPS,
    bind,
    check_launch,
    check_operands,
    cuda_or_plain,
    plain_pd,
    plain_scores,
    ptr,
    stream_ptr,
)
from feta_tmlr_tpu_torch.ops.laplacian import rsqrt_pos

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        lib = build.load("colstat")
        _fn = (lib, bind(lib, "feta_colstat", 14, 4))
    return _fn


def colstat_plain(xa, x, cq, ck, c0, pe, deg, mask, inv_sqrt, m, se, su,
                  wq=None):
    """Dense version of the kernel: (colsum, diag), each [B, H, N]."""
    s = plain_scores(xa, x, cq, ck, c0, mask, inv_sqrt)
    e = torch.exp(s - m[..., None])
    denom = su / se
    safe = torch.where(denom.abs() > EPS, denom, torch.ones_like(denom))
    qa = mask[:, None, :] / safe
    attn = (e * (1.0 / se)[..., None] * plain_pd(pe, deg, xa)
            * qa[..., None] * mask[:, None, None, :])
    w = attn if wq is None else attn * wq[..., None]
    return w.sum(-2), torch.diagonal(attn, dim1=-2, dim2=-1)


def colstat(xa, x, cq, ck, c0, pe, deg, mask, inv_sqrt, m, se, su, wq=None):
    """colsum[b,h,j] = sum_i attn[i,j] * wq[i] (wq None: 1) and
    diag[b,h,j] = attn[j,j], attn recomputed from (m, se, su)."""
    if not cuda_or_plain("colstat", xa):
        return colstat_plain(xa, x, cq, ck, c0, pe, deg, mask, inv_sqrt,
                             m, se, su, wq)
    b, h, n, d = xa.shape
    check_operands("colstat", xa, x, cq, ck, c0, pe, deg, mask,
                   extra=[(k, t, (b, h, n)) for k, t in
                          (("m", m), ("se", se), ("su", su), ("wq", wq))])
    lib, fn = _kernel()
    colsum, diag = (torch.empty((b, h, n), dtype=torch.float32,
                                device=xa.device) for _ in range(2))
    err = fn(ptr(xa), ptr(x), ptr(cq), ptr(ck), ptr(c0), ptr(pe), ptr(deg),
             ptr(mask), ptr(m), ptr(se), ptr(su), ptr(wq), ptr(colsum),
             ptr(diag), b, h, n, d, float(inv_sqrt), stream_ptr(xa.device))
    check_launch(lib, err, "colstat")
    colstat.launches += 1
    return colsum, diag


colstat.launches = 0


def attention_column_gcn_sums(xa, x, cq, ck, c0, pe, deg, mask, inv_sqrt,
                              m, se, su, fill: float = 1.0):
    """s[b, h, j] = sum_i gcn_norm_directed(attn)[b, h, i, j] in two
    column-statistics passes:

      pass 1: colsum[j] = sum_i attn[i, j],  diag[j] = attn[j, j]
      deg_in  = colsum + fill * missing,  missing = (diag == 0) on real nodes
      pass 2: wcolsum[j] = sum_i attn[i, j] * deg_in[i]^-1/2
      s[j]    = deg_in[j]^-1/2 * (wcolsum[j] + fill * missing[j] *
                deg_in[j]^-1/2)
    """
    args = (xa, x, cq, ck, c0, pe, deg, mask, inv_sqrt, m, se, su)
    colsum, diag = colstat(*args)
    missing = (diag == 0).to(mask.dtype) * mask[:, None, :]
    dis = rsqrt_pos(colsum + fill * missing)
    wcolsum, _ = colstat(*args, wq=dis.contiguous())
    return dis * (wcolsum + fill * missing * dis)
