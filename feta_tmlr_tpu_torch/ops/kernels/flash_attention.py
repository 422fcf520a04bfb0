"""GraphiT attention through the online-softmax kernels, forward and backward.

Kernels:
  `csrc/flash_fwd.cu`  the H100 counterpart of the TPU kernel
                       `feta_tmlr_tpu/ops/pallas/flash_attention.py::_fwd_kernel`;
  `csrc/flash_bwd.cu`  the counterparts of `_bwd_q_kernel` (dxa, dcq) and
                       `_bwd_k_kernel` (dvw, dck, dx).
Their source notes say what bounds them (f32 arithmetic on CUDA cores) and
how the design answers that.

`flash_fwd`, `flash_bwd_q` and `flash_bwd_k` are the wrappers: on a CUDA
tensor each launches its kernel and counts the launch in its `launches`
attribute; on a CPU tensor each runs its plain version (`*_plain`), the same
function from dense [B, H, N, N] tensors. There is no other route and no
fallback. `FlashGraphiT` is the `torch.autograd.Function` that ties the
forward to the two backward kernels.

Public entry points mirror the JAX package:
  flash_graphit_attention        need_heads=False layers: sum_h attn_h @ vw_h
  flash_graphit_attention_heads  the filtered layer: per-head outputs plus
                                 the detached coefficient-head signal s
"""

from __future__ import annotations

import math

import torch
from torch.autograd.function import once_differentiable

from feta_tmlr_tpu_torch.ops.kernels import build
from feta_tmlr_tpu_torch.ops.kernels.colstat import attention_column_gcn_sums
from feta_tmlr_tpu_torch.ops.kernels.common import (
    EPS,
    bind,
    bwd_row_constants,
    check_launch,
    check_operands,
    cuda_or_plain,
    plain_pd,
    plain_scores,
    ptr,
    stream_ptr,
)

_fns = {}


def _kernel(name):
    """(lib, bound C function) for "fwd", "bwd_q" or "bwd_k"."""
    if name not in _fns:
        if name == "fwd":
            lib = build.load("flash_fwd")
            _fns[name] = (lib, bind(lib, "feta_flash_fwd", 13, 5))
        else:
            lib = build.load("flash_bwd")
            n_ptrs = 17 if name == "bwd_q" else 19
            _fns[name] = (lib, bind(lib, f"feta_flash_{name}", n_ptrs, 5))
    return _fns[name]


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
    if not cuda_or_plain("flash_fwd", xa):
        return flash_fwd_plain(xa, x, cq, ck, c0, vw, pe, deg, mask, inv_sqrt)
    b, h, n, d = xa.shape
    dv = vw.shape[-1]
    check_operands("flash_fwd", xa, x, cq, ck, c0, pe, deg, mask,
                   extra=[("vw", vw, (b, h, n, dv))])
    if dv > 64:
        raise ValueError(f"flash_fwd: value width {dv} > 64")
    lib, fn = _kernel("fwd")
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


# ---------------------------------------------------------------- backward
#
# Operands of both passes: the forward's (xa, x, cq, ck, c0, vw, pe, deg,
# mask, inv_sqrt), the per-head cotangent g [B, H, N, dv], the forward's
# row maximum m and the row constants ise, qa, beta, c [B, H, N]
# (`common.bwd_row_constants`).

def _plain_tiles(xa, x, cq, ck, c0, vw, pe, deg, mask, inv_sqrt, g, m, ise,
                 qa, beta, c):
    """Dense (ds, attn) [B, H, N, N], recomputed as the kernels do."""
    s = plain_scores(xa, x, cq, ck, c0, mask, inv_sqrt)
    a = torch.exp(s - m[..., None]) * ise[..., None]
    pd = plain_pd(pe, deg, xa)
    km = mask[:, None, None, :]
    attn = a * pd * qa[..., None] * km
    du = (g @ vw.transpose(-1, -2)) * km * qa[..., None] - beta[..., None]
    ds = a * (du * pd - c[..., None]) * inv_sqrt
    return ds, attn


def flash_bwd_q_plain(*args):
    """Dense version of the q pass: (dxa [B,H,N,D], dcq [B,H,N])."""
    ds, _ = _plain_tiles(*args)
    return ds @ args[1][:, None], ds.sum(-1)


def flash_bwd_k_plain(*args):
    """Dense version of the k pass: (dvw [B,H,N,dv], dck [B,H,N],
    dx [B,N,D])."""
    ds, attn = _plain_tiles(*args)
    xa, g = args[0], args[10]
    return (attn.transpose(-1, -2) @ g, ds.sum(-2),
            (ds.transpose(-1, -2) @ xa).sum(1))


def flash_bwd_plain(*args):
    """Dense version of both passes: (dxa, dcq, dvw, dck, dx)."""
    return flash_bwd_q_plain(*args) + flash_bwd_k_plain(*args)


def _check_bwd(name, xa, x, cq, ck, c0, vw, pe, deg, mask, inv_sqrt, g, m,
               ise, qa, beta, c):
    b, h, n, d = xa.shape
    dv = vw.shape[-1]
    rows = [(k, t, (b, h, n)) for k, t in (("m", m), ("ise", ise), ("qa", qa),
                                           ("beta", beta), ("c", c))]
    check_operands(name, xa, x, cq, ck, c0, pe, deg, mask,
                   extra=[("vw", vw, (b, h, n, dv)), ("g", g, (b, h, n, dv)),
                          *rows])
    if d > 64 or dv > 64:
        raise ValueError(f"{name}: width {d} or value width {dv} > 64")
    return b, h, n, d, dv


def flash_bwd_q(xa, x, cq, ck, c0, vw, pe, deg, mask, inv_sqrt, g, m, ise,
                qa, beta, c):
    """Query pass of the backward: (dxa [B,H,N,D], dcq [B,H,N])."""
    args = (xa, x, cq, ck, c0, vw, pe, deg, mask, inv_sqrt, g, m, ise, qa,
            beta, c)
    if not cuda_or_plain("flash_bwd_q", xa):
        return flash_bwd_q_plain(*args)
    b, h, n, d, dv = _check_bwd("flash_bwd_q", *args)
    lib, fn = _kernel("bwd_q")
    dxa = torch.empty((b, h, n, d), dtype=torch.float32, device=xa.device)
    dcq = torch.empty((b, h, n), dtype=torch.float32, device=xa.device)
    err = fn(*(ptr(t) for t in args[:9]), *(ptr(t) for t in args[10:]),
             ptr(dxa), ptr(dcq), b, h, n, d, dv, float(inv_sqrt),
             stream_ptr(xa.device))
    check_launch(lib, err, "flash_bwd_q")
    flash_bwd_q.launches += 1
    return dxa, dcq


def flash_bwd_k(xa, x, cq, ck, c0, vw, pe, deg, mask, inv_sqrt, g, m, ise,
                qa, beta, c):
    """Key pass of the backward: (dvw [B,H,N,dv], dck [B,H,N], dx [B,N,D]).
    One call is two launches from `csrc/flash_bwd.cu`: the pass itself,
    which writes one dx partial per head, and the fixed-order head sum."""
    args = (xa, x, cq, ck, c0, vw, pe, deg, mask, inv_sqrt, g, m, ise, qa,
            beta, c)
    if not cuda_or_plain("flash_bwd_k", xa):
        return flash_bwd_k_plain(*args)
    b, h, n, d, dv = _check_bwd("flash_bwd_k", *args)
    lib, fn = _kernel("bwd_k")
    dev = xa.device
    dvw = torch.empty((b, h, n, dv), dtype=torch.float32, device=dev)
    dck = torch.empty((b, h, n), dtype=torch.float32, device=dev)
    dx_heads = torch.empty((b, h, n, d), dtype=torch.float32, device=dev)
    dx = torch.empty((b, n, d), dtype=torch.float32, device=dev)
    err = fn(*(ptr(t) for t in args[:9]), *(ptr(t) for t in args[10:]),
             ptr(dvw), ptr(dck), ptr(dx_heads), ptr(dx), b, h, n, d, dv,
             float(inv_sqrt), stream_ptr(dev))
    check_launch(lib, err, "flash_bwd_k")
    flash_bwd_k.launches += 1
    return dvw, dck, dx


flash_bwd_q.launches = 0
flash_bwd_k.launches = 0


def flash_bwd(*args):
    """Both backward passes: (dxa, dcq, dvw, dck, dx)."""
    return flash_bwd_q(*args) + flash_bwd_k(*args)


class FlashGraphiT(torch.autograd.Function):
    """outh, m, se, su = flash_fwd(...) with a backward through the two
    backward kernels. m, se and su are not differentiable: they feed only
    the detached coefficient head (the JAX package's `_flash_heads_bwd`
    drops their cotangents too)."""

    @staticmethod
    def forward(ctx, xa, x, cq, ck, c0, vw, pe, deg, mask, inv_sqrt):
        outh, m, se, su = flash_fwd(xa, x, cq, ck, c0, vw, pe, deg, mask,
                                    inv_sqrt)
        ctx.save_for_backward(xa, x, cq, ck, c0, vw, pe, deg, mask, outh, m,
                              se, su)
        ctx.inv_sqrt = inv_sqrt
        ctx.mark_non_differentiable(m, se, su)
        return outh, m, se, su

    @staticmethod
    @once_differentiable
    def backward(ctx, g, _gm, _gse, _gsu):
        xa, x, cq, ck, c0, vw, pe, deg, mask, outh, m, se, su = \
            ctx.saved_tensors
        g = g.contiguous()        # the head sum's cotangent is expanded
        ise, qa, beta, c = bwd_row_constants(g, outh, se, su, mask)
        dxa, dcq, dvw, dck, dx = flash_bwd(
            xa, x, cq, ck, c0, vw, pe, deg, mask, ctx.inv_sqrt, g, m, ise,
            qa, beta, c)
        return dxa, dx, dcq, dck, dcq.sum((0, 2)), dvw, None, None, None, None


def prepare(xa, x, cq, ck, c0, node_mask, pe, degree):
    """Public-layout operands -> the kernels' layout (see `common`):
    cq/ck [B, N, H] -> [B, H, N], a float mask, 1/sqrt(head dim). Operands
    become float32, except that float64 xa keeps everything in float64: a
    reference run on the CPU (the CUDA kernels take float32 only)."""
    b, h, n, d = xa.shape
    dt = torch.float64 if xa.dtype == torch.float64 else torch.float32
    cast = lambda t: None if t is None else t.to(dt).contiguous()
    return dict(
        xa=cast(xa), x=cast(x), cq=cast(cq.transpose(1, 2)),
        ck=cast(ck.transpose(1, 2)), c0=cast(c0.reshape(h)), pe=cast(pe),
        deg=cast(degree), mask=cast(node_mask),
        inv_sqrt=1.0 / math.sqrt(d // h))


def _flash(ops, vw):
    return FlashGraphiT.apply(
        ops["xa"], ops["x"], ops["cq"], ops["ck"], ops["c0"],
        vw.to(ops["xa"].dtype).contiguous(), ops["pe"], ops["deg"],
        ops["mask"], ops["inv_sqrt"])


def flash_graphit_attention(xa, x, cq, ck, c0, vw, node_mask, pe=None,
                            degree=None):
    """out [B, N, D] = sum_h modulated_attn_h @ vw_h.

    xa [B,H,N,D] = x @ Wq_h Wk_h^T, x [B,N,D], cq/ck [B,N,H] rank-1 bias
    terms, c0 [H], vw [B,H,N,D] = v_h @ Wout_h, node_mask [B,N], optional
    pe [B,N,N] and degree [B,N]."""
    outh, _, _, _ = _flash(prepare(xa, x, cq, ck, c0, node_mask, pe, degree),
                           vw)
    return outh.sum(1)       # autograd hands every head the same cotangent


def flash_graphit_attention_heads(xa, x, cq, ck, c0, v_heads, node_mask,
                                  pe=None, degree=None,
                                  coeff_fill: float = 1.0):
    """The filtered layer's attention: per-head outputs and the detached
    coefficient-head signal s[b, h, j] = sum_i gcn_norm_directed(attn)[i, j],
    with no [B, H, N, N] tensor on the CUDA route.

    v_heads [B, H, N, dh] per-head values (not folded with W_out).
    Returns (out_each_head [B, N, H, dh], s [B, H, N])."""
    ops = prepare(xa, x, cq, ck, c0, node_mask, pe, degree)
    outh, m, se, su = _flash(ops, v_heads)
    with torch.no_grad():                    # s is detached by definition
        s = attention_column_gcn_sums(m=m, se=se, su=su, fill=coeff_fill,
                                      **ops)
    return outh.transpose(1, 2), s
