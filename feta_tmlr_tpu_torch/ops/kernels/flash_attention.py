"""GraphiT attention through the online-softmax forward kernel.

Kernel: `csrc/flash_fwd.cu`, the H100 counterpart of the TPU kernel
`feta_tmlr_tpu/ops/pallas/flash_attention.py::_fwd_kernel`. Its source note
says what bounds it (f32 arithmetic on CUDA cores, about 2·B·H·N²·(D+dv)
flops) and how the design answers that.

`flash_fwd` is the wrapper: on a CUDA tensor it launches the kernel and
counts the launch in `flash_fwd.launches`; on a CPU tensor it runs
`flash_fwd_plain`, the same function from dense [B, H, N, N] tensors.
There is no other route and no fallback.

Public entry points mirror the JAX package:
  flash_graphit_attention        need_heads=False layers: sum_h attn_h @ vw_h
  flash_graphit_attention_heads  the filtered layer: per-head outputs plus
                                 the detached coefficient-head signal s
"""

from __future__ import annotations

import math

import torch

from feta_tmlr_tpu_torch.ops.kernels import build
from feta_tmlr_tpu_torch.ops.kernels.colstat import attention_column_gcn_sums
from feta_tmlr_tpu_torch.ops.kernels.common import (
    EPS,
    bind,
    check_launch,
    check_operands,
    plain_pd,
    plain_scores,
    ptr,
    stream_ptr,
)

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        lib = build.load("flash_fwd")
        _fn = (lib, bind(lib, "feta_flash_fwd", 13, 5))
    return _fn


def flash_fwd_plain(xa, x, cq, ck, c0, vw, pe, deg, mask, inv_sqrt):
    """Dense version of the kernel: (outh [B,H,N,dv], m, se, su [B,H,N])."""
    s = plain_scores(xa, x, cq, ck, c0, mask, inv_sqrt)
    m = s.amax(-1)
    e = torch.exp(s - m[..., None])
    w = e * plain_pd(pe, deg, xa)
    se = e.sum(-1)
    su = w.sum(-1)
    acc = (w * mask[:, None, None, :]) @ vw
    div = torch.where((su / se).abs() > EPS, su, se)
    outh = acc / div[..., None] * mask[:, None, :, None]
    return outh, m, se, su


def flash_fwd(xa, x, cq, ck, c0, vw, pe, deg, mask, inv_sqrt):
    """Online-softmax GraphiT forward (operand layout in `common`; vw is
    [B, H, N, dv] with dv <= 64). Returns (outh, m, se, su)."""
    if xa.device.type == "cpu":
        return flash_fwd_plain(xa, x, cq, ck, c0, vw, pe, deg, mask, inv_sqrt)
    if xa.device.type != "cuda":
        raise ValueError(f"flash_fwd: unsupported device {xa.device}")
    b, h, n, d = xa.shape
    dv = vw.shape[-1]
    check_operands("flash_fwd", xa, x, cq, ck, c0, pe, deg, mask,
                   extra=[("vw", vw, (b, h, n, dv))])
    if dv > 64:
        raise ValueError(f"flash_fwd: value width {dv} > 64")
    lib, fn = _kernel()
    outh = torch.empty((b, h, n, dv), dtype=torch.float32, device=xa.device)
    m, se, su = (torch.empty((b, h, n), dtype=torch.float32,
                             device=xa.device) for _ in range(3))
    err = fn(ptr(xa), ptr(x), ptr(cq), ptr(ck), ptr(c0), ptr(vw), ptr(pe),
             ptr(deg), ptr(mask), ptr(outh), ptr(m), ptr(se), ptr(su),
             b, h, n, d, dv, float(inv_sqrt), stream_ptr(xa.device))
    check_launch(lib, err, "flash_fwd")
    flash_fwd.launches += 1
    return outh, m, se, su


flash_fwd.launches = 0


def prepare(xa, x, cq, ck, c0, node_mask, pe, degree):
    """Public-layout operands -> the kernels' layout (see `common`):
    cq/ck [B, N, H] -> [B, H, N], float32 mask, 1/sqrt(head dim)."""
    b, h, n, d = xa.shape
    f32 = lambda t: None if t is None else t.to(torch.float32).contiguous()
    return dict(
        xa=f32(xa), x=f32(x), cq=f32(cq.transpose(1, 2)),
        ck=f32(ck.transpose(1, 2)), c0=f32(c0.reshape(h)), pe=f32(pe),
        deg=f32(degree), mask=f32(node_mask),
        inv_sqrt=1.0 / math.sqrt(d // h))


def flash_graphit_attention(xa, x, cq, ck, c0, vw, node_mask, pe=None,
                            degree=None):
    """out [B, N, D] = sum_h modulated_attn_h @ vw_h.

    xa [B,H,N,D] = x @ Wq_h Wk_h^T, x [B,N,D], cq/ck [B,N,H] rank-1 bias
    terms, c0 [H], vw [B,H,N,D] = v_h @ Wout_h, node_mask [B,N], optional
    pe [B,N,N] and degree [B,N]."""
    ops = prepare(xa, x, cq, ck, c0, node_mask, pe, degree)
    outh, _, _, _ = flash_fwd(vw=vw.to(torch.float32).contiguous(), **ops)
    return outh.sum(1)


def flash_graphit_attention_heads(xa, x, cq, ck, c0, v_heads, node_mask,
                                  pe=None, degree=None,
                                  coeff_fill: float = 1.0):
    """The filtered layer's attention: per-head outputs and the detached
    coefficient-head signal s[b, h, j] = sum_i gcn_norm_directed(attn)[i, j],
    with no [B, H, N, N] tensor on the CUDA route.

    v_heads [B, H, N, dh] per-head values (not folded with W_out).
    Returns (out_each_head [B, N, H, dh], s [B, H, N])."""
    ops = prepare(xa, x, cq, ck, c0, node_mask, pe, degree)
    outh, m, se, su = flash_fwd(
        vw=v_heads.to(torch.float32).contiguous(), **ops)
    with torch.no_grad():                    # s is detached by definition
        s = attention_column_gcn_sums(m=m, se=se, su=su, fill=coeff_fill,
                                      **ops)
    return outh.transpose(1, 2), s
