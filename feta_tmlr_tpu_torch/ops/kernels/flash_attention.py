"""GraphiT attention through the online-softmax kernels, forward and backward.

Kernels:
  `csrc/flash_fwd.cu`  the H100 counterpart of the TPU kernel
                       `feta_tmlr_tpu/ops/pallas/flash_attention.py::_fwd_kernel`;
  `csrc/flash_bwd.cu`  the counterparts of `_bwd_q_kernel` (dxa, dcq) and
                       `_bwd_k_kernel` (dvw, dck, dx);
  `csrc/flash_hf.cu`   the head-folded counterparts of `_fwd_kernel_hf`,
                       `_bwd_q_kernel_hf` and `_bwd_k_kernel_hf`: the same
                       three functions, one block per (graph, tile) for all
                       heads (the JAX package's FETA_FLASH_HEAD_FOLD=1);
  `csrc/bwd_q.cuh`     the query passes' one kernel body, which both
                       sources launch, each on its own grid.
Their source notes say what bounds them and how the design answers that:
the forwards take their products on CUDA cores in f32, the backward
passes their score likewise (the forwards' FMA chain, bit for bit) and
their other products on the tensor cores in error-compensated TF32
(`csrc/mma_tf32.cuh`: three TF32 products per f32 product, float32
accuracy).

`flash_fwd`, `flash_bwd_q`, `flash_bwd_k` and their folded twins
`flash_fwd_hf`, `flash_bwd_q_hf`, `flash_bwd_k_hf` are the wrappers: on a
CUDA tensor each launches its kernel and counts the launch in its
`launches` attribute; on a CPU tensor each runs its plain version
(`*_plain`, shared by a kernel and its folded twin), the same function from
dense [B, H, N, N] tensors. There is no other route and no fallback.
`FlashGraphiT` is the `torch.autograd.Function` that ties the forward to
the two backward kernels, folded or not (`head_fold`).

Public entry points mirror the JAX package:
  flash_graphit_attention        need_heads=False layers: sum_h attn_h @ vw_h
  flash_graphit_attention_heads  the filtered layer: per-head outputs plus
                                 the detached coefficient-head signal s
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

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


class _Kernel(NamedTuple):
    """What a wrapper's launch code needs to know of its kernel."""

    source: str                  # under csrc/
    symbol: str                  # its C entry point
    n_ptrs: int                  # the entry point's pointer arguments
    dx_scratch: bool = False     # the k pass writes one dx partial a head
    max_heads: Optional[int] = None
    splits: bool = False         # the folded k pass splits its query loop


# wrapper name -> its kernel; the folded kernels run the heads side by side
_SYMBOLS = {
    "flash_fwd": _Kernel("flash_fwd", "feta_flash_fwd", 13),
    "flash_bwd_q": _Kernel("flash_bwd", "feta_flash_bwd_q", 17),
    "flash_bwd_k": _Kernel("flash_bwd", "feta_flash_bwd_k", 19,
                           dx_scratch=True),
    "flash_fwd_hf": _Kernel("flash_hf", "feta_flash_fwd_hf", 13,
                            max_heads=8),
    "flash_bwd_q_hf": _Kernel("flash_hf", "feta_flash_bwd_q_hf", 17,
                              max_heads=8),
    "flash_bwd_k_hf": _Kernel("flash_hf", "feta_flash_bwd_k_hf", 19,
                              max_heads=8, splits=True)}
K_HF_KEYS = 32        # keys per block of the folded k pass
K_HF_MAX_SPLITS = 4
_fns = {}


def _kernel(name):
    """(lib, bound C function) of the wrapper `name`."""
    if name not in _fns:
        k = _SYMBOLS[name]
        lib = build.load(k.source)
        _fns[name] = (lib, bind(lib, k.symbol, k.n_ptrs,
                                6 if k.splits else 5))
    return _fns[name]


def _check_heads(name, h):
    limit = _SYMBOLS[name].max_heads
    if limit is not None and h > limit:
        raise ValueError(f"{name}: {h} heads > {limit}")


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


def _launch_fwd(name, xa, x, cq, ck, c0, vw, pe, deg, mask, inv_sqrt):
    b, h, n, d = xa.shape
    dv = vw.shape[-1]
    check_operands(name, xa, x, cq, ck, c0, pe, deg, mask,
                   extra=[("vw", vw, (b, h, n, dv))])
    if dv > 64:
        raise ValueError(f"{name}: value width {dv} > 64")
    _check_heads(name, h)
    lib, fn = _kernel(name)
    outh = torch.empty((b, h, n, dv), dtype=torch.float32, device=xa.device)
    m, se, su = (torch.empty((b, h, n), dtype=torch.float32,
                             device=xa.device) for _ in range(3))
    err = fn(ptr(xa), ptr(x), ptr(cq), ptr(ck), ptr(c0), ptr(vw), ptr(pe),
             ptr(deg), ptr(mask), ptr(outh), ptr(m), ptr(se), ptr(su),
             b, h, n, d, dv, float(inv_sqrt), stream_ptr(xa.device))
    check_launch(lib, err, name)
    return outh, m, se, su


def flash_fwd(xa, x, cq, ck, c0, vw, pe, deg, mask, inv_sqrt):
    """Online-softmax GraphiT forward (operand layout in `common`; vw is
    [B, H, N, dv] with dv <= 64). Returns (outh, m, se, su)."""
    if not cuda_or_plain("flash_fwd", xa):
        return flash_fwd_plain(xa, x, cq, ck, c0, vw, pe, deg, mask, inv_sqrt)
    out = _launch_fwd("flash_fwd", xa, x, cq, ck, c0, vw, pe, deg, mask,
                      inv_sqrt)
    flash_fwd.launches += 1
    return out


def flash_fwd_hf(xa, x, cq, ck, c0, vw, pe, deg, mask, inv_sqrt):
    """Head-folded forward (`csrc/flash_hf.cu`, TPU `_fwd_kernel_hf`): the
    same function as `flash_fwd`, so its plain version is
    `flash_fwd_plain`; one block per (graph, 16-query tile) for all heads
    (H <= 8)."""
    if not cuda_or_plain("flash_fwd_hf", xa):
        return flash_fwd_plain(xa, x, cq, ck, c0, vw, pe, deg, mask, inv_sqrt)
    out = _launch_fwd("flash_fwd_hf", xa, x, cq, ck, c0, vw, pe, deg, mask,
                      inv_sqrt)
    flash_fwd_hf.launches += 1
    return out


flash_fwd.launches = 0
flash_fwd_hf.launches = 0


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
    _check_heads(name, h)
    return b, h, n, d, dv


def _launch_bwd_q(name, *args):
    b, h, n, d, dv = _check_bwd(name, *args)
    xa, inv_sqrt = args[0], args[9]
    lib, fn = _kernel(name)
    dxa = torch.empty((b, h, n, d), dtype=torch.float32, device=xa.device)
    dcq = torch.empty((b, h, n), dtype=torch.float32, device=xa.device)
    err = fn(*(ptr(t) for t in args[:9]), *(ptr(t) for t in args[10:]),
             ptr(dxa), ptr(dcq), b, h, n, d, dv, float(inv_sqrt),
             stream_ptr(xa.device))
    check_launch(lib, err, name)
    return dxa, dcq


def k_hf_splits(device, b, n):
    """Blocks per key tile of the folded k pass, each over its share of
    the query tiles: as many as keep the B * ceil(N / 32) key tiles times
    the splits within one block per SM (its shared memory allows one), at
    most K_HF_MAX_SPLITS. 2 at the training shape B=1, N=2048 on 132 SMs:
    128 blocks, and no more L2 traffic than one block per key tile."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    tiles = b * -(-n // K_HF_KEYS)
    return max(1, min(K_HF_MAX_SPLITS, sms // tiles))


def _launch_bwd_k(name, *args):
    """The k pass; the unfolded kernel takes one dx partial per head as
    scratch, the folded one sums the heads itself and takes the partials
    of its query splits as scratch where it splits."""
    b, h, n, d, dv = _check_bwd(name, *args)
    xa, inv_sqrt = args[0], args[9]
    lib, fn = _kernel(name)
    dev = xa.device
    dvw = torch.empty((b, h, n, dv), dtype=torch.float32, device=dev)
    dck = torch.empty((b, h, n), dtype=torch.float32, device=dev)
    dx = torch.empty((b, n, d), dtype=torch.float32, device=dev)
    f32 = dict(dtype=torch.float32, device=dev)
    if _SYMBOLS[name].dx_scratch:
        outs = (dvw, dck, torch.empty((b, h, n, d), **f32), dx)
        ints = ()
    else:
        splits = k_hf_splits(dev, b, n)
        parts = (torch.empty((splits * (b * h * n * (dv + 1) + b * n * d),),
                             **f32) if splits > 1 else None)
        outs, ints = (dvw, dck, dx, parts), (splits,)
    err = fn(*(ptr(t) for t in args[:9]), *(ptr(t) for t in args[10:]),
             *(ptr(t) for t in outs), b, h, n, d, dv, *ints,
             float(inv_sqrt), stream_ptr(dev))
    check_launch(lib, err, name)
    return dvw, dck, dx


def flash_bwd_q(xa, x, cq, ck, c0, vw, pe, deg, mask, inv_sqrt, g, m, ise,
                qa, beta, c):
    """Query pass of the backward: (dxa [B,H,N,D], dcq [B,H,N])."""
    args = (xa, x, cq, ck, c0, vw, pe, deg, mask, inv_sqrt, g, m, ise, qa,
            beta, c)
    if not cuda_or_plain("flash_bwd_q", xa):
        return flash_bwd_q_plain(*args)
    out = _launch_bwd_q("flash_bwd_q", *args)
    flash_bwd_q.launches += 1
    return out


def flash_bwd_k(xa, x, cq, ck, c0, vw, pe, deg, mask, inv_sqrt, g, m, ise,
                qa, beta, c):
    """Key pass of the backward: (dvw [B,H,N,dv], dck [B,H,N], dx [B,N,D]).
    One call is two launches from `csrc/flash_bwd.cu`: the pass itself,
    which writes one dx partial per head, and the fixed-order head sum."""
    args = (xa, x, cq, ck, c0, vw, pe, deg, mask, inv_sqrt, g, m, ise, qa,
            beta, c)
    if not cuda_or_plain("flash_bwd_k", xa):
        return flash_bwd_k_plain(*args)
    out = _launch_bwd_k("flash_bwd_k", *args)
    flash_bwd_k.launches += 1
    return out


def flash_bwd_q_hf(xa, x, cq, ck, c0, vw, pe, deg, mask, inv_sqrt, g, m,
                   ise, qa, beta, c):
    """Head-folded query pass (`csrc/flash_hf.cu`, TPU `_bwd_q_kernel_hf`):
    the same function as `flash_bwd_q`, so its plain version is
    `flash_bwd_q_plain`; one block per (graph, 16-query tile) for all
    heads (H <= 8). It runs `flash_bwd_q`'s kernel body
    (`csrc/bwd_q.cuh`) on the folded grid, so the two agree bit for
    bit."""
    args = (xa, x, cq, ck, c0, vw, pe, deg, mask, inv_sqrt, g, m, ise, qa,
            beta, c)
    if not cuda_or_plain("flash_bwd_q_hf", xa):
        return flash_bwd_q_plain(*args)
    out = _launch_bwd_q("flash_bwd_q_hf", *args)
    flash_bwd_q_hf.launches += 1
    return out


def flash_bwd_k_hf(xa, x, cq, ck, c0, vw, pe, deg, mask, inv_sqrt, g, m,
                   ise, qa, beta, c):
    """Head-folded key pass (`csrc/flash_hf.cu`, TPU `_bwd_k_kernel_hf`):
    the same function as `flash_bwd_k`, so its plain version is
    `flash_bwd_k_plain`; one block per (graph, 32-key tile, query split)
    for all heads (H <= 8), which sums dx over the heads itself in a fixed
    order, no per-head partials; with several splits (`k_hf_splits`) a
    second launch adds their partials in order."""
    args = (xa, x, cq, ck, c0, vw, pe, deg, mask, inv_sqrt, g, m, ise, qa,
            beta, c)
    if not cuda_or_plain("flash_bwd_k_hf", xa):
        return flash_bwd_k_plain(*args)
    out = _launch_bwd_k("flash_bwd_k_hf", *args)
    flash_bwd_k_hf.launches += 1
    return out


flash_bwd_q.launches = 0
flash_bwd_k.launches = 0
flash_bwd_q_hf.launches = 0
flash_bwd_k_hf.launches = 0


def flash_bwd(*args, head_fold=False):
    """Both backward passes, folded or not: (dxa, dcq, dvw, dck, dx)."""
    if head_fold:
        return flash_bwd_q_hf(*args) + flash_bwd_k_hf(*args)
    return flash_bwd_q(*args) + flash_bwd_k(*args)


class FlashGraphiT(torch.autograd.Function):
    """outh, m, se, su = flash_fwd(...) with a backward through the two
    backward kernels; `head_fold` (not differentiable, as `hf` is a
    nondiff argument of the JAX package's `_flash`) picks the folded
    kernels for the forward and the backward alike. m, se and su are not
    differentiable: they feed only the detached coefficient head (the JAX
    package's `_flash_heads_bwd` drops their cotangents too)."""

    @staticmethod
    def forward(ctx, xa, x, cq, ck, c0, vw, pe, deg, mask, inv_sqrt,
                head_fold=False):
        fwd = flash_fwd_hf if head_fold else flash_fwd
        outh, m, se, su = fwd(xa, x, cq, ck, c0, vw, pe, deg, mask, inv_sqrt)
        ctx.save_for_backward(xa, x, cq, ck, c0, vw, pe, deg, mask, outh, m,
                              se, su)
        ctx.inv_sqrt = inv_sqrt
        ctx.head_fold = head_fold
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
            qa, beta, c, head_fold=ctx.head_fold)
        return (dxa, dx, dcq, dck, dcq.sum((0, 2)), dvw, None, None, None,
                None, None)


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


def _flash(ops, vw, head_fold):
    return FlashGraphiT.apply(
        ops["xa"], ops["x"], ops["cq"], ops["ck"], ops["c0"],
        vw.to(ops["xa"].dtype).contiguous(), ops["pe"], ops["deg"],
        ops["mask"], ops["inv_sqrt"], head_fold)


def flash_graphit_attention(xa, x, cq, ck, c0, vw, node_mask, pe=None,
                            degree=None, head_fold: bool = False):
    """out [B, N, D] = sum_h modulated_attn_h @ vw_h.

    xa [B,H,N,D] = x @ Wq_h Wk_h^T, x [B,N,D], cq/ck [B,N,H] rank-1 bias
    terms, c0 [H], vw [B,H,N,D] = v_h @ Wout_h, node_mask [B,N], optional
    pe [B,N,N] and degree [B,N]. head_fold: the head-folded kernels (JAX's
    FETA_FLASH_HEAD_FOLD=1), forward and backward."""
    outh, _, _, _ = _flash(prepare(xa, x, cq, ck, c0, node_mask, pe, degree),
                           vw, head_fold)
    return outh.sum(1)       # autograd hands every head the same cotangent


def flash_graphit_attention_heads(xa, x, cq, ck, c0, v_heads, node_mask,
                                  pe=None, degree=None,
                                  coeff_fill: float = 1.0,
                                  head_fold: bool = False):
    """The filtered layer's attention: per-head outputs and the detached
    coefficient-head signal s[b, h, j] = sum_i gcn_norm_directed(attn)[i, j],
    with no [B, H, N, N] tensor on the CUDA route.

    v_heads [B, H, N, dh] per-head values (not folded with W_out);
    head_fold as in `flash_graphit_attention` (the column statistics have
    one kernel either way, as in the JAX package).
    Returns (out_each_head [B, N, H, dh], s [B, H, N])."""
    ops = prepare(xa, x, cq, ck, c0, node_mask, pe, degree)
    outh, m, se, su = _flash(ops, v_heads, head_fold)
    with torch.no_grad():                    # s is detached by definition
        s = attention_column_gcn_sums(m=m, se=se, su=su, fill=coeff_fill,
                                      **ops)
    return outh.transpose(1, 2), s
