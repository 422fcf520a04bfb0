"""Fused GraphiT attention for small graphs, forward and backward.

Kernels: `csrc/fused_attention.cu`, the H100 counterparts of the TPU
kernels `feta_tmlr_tpu/ops/pallas/fused_attention.py::_fwd_kernel` and
`::_bwd_kernel`. They compute the function of the online-softmax kernels
(`flash_attention.py`), out [B, N, D] = sum_h modulated_attn_h @ vw_h, but
hold a query's whole key row in one warp's registers, so the softmax is
exact with no rescaling. Each graph is one thread-block cluster of
`cluster_size(H)` CTAs, each CTA a group of heads and each warp 16
queries; every product but the score runs on the tensor cores in 3xTF32,
and the head sums (out, dx) are taken across the cluster's CTAs in rank
order through distributed shared memory, with no atomics. The source note
says what bounds them and their limits: N <= `MAX_NODES` and D <= 64.

`fused_attn_fwd` and `fused_attn_bwd` are the wrappers: on a CUDA tensor
each launches its kernel and counts the launch in its `launches` attribute;
on a CPU tensor each runs its plain version (`fused_attn_fwd_plain`,
`fused_attn_bwd_plain`), which also takes float64. Above N = `MAX_NODES`
a CUDA tensor raises; there is no fallback. `FusedGraphiT` is the
`torch.autograd.Function` that ties them together, and
`fused_graphit_attention` the entry point (public layout as in the JAX
package).

bf16 operands (the bf16 compute policy, `config.py`): both kernels also
take xa, x, vw and g in bf16 (their `_bf16` entry points), with cq, ck,
c0, pe, deg and the mask float32, as the JAX wrapper casts them
(`fused_attention.py:245-262`); out, dxa, dx and dvw follow the values'
dtype, dcq, dck and dc0 stay float32. The plain versions compute from such
operands in float32, round attn (and in the backward ds) to bf16 where the
JAX kernels cast them, then each output once to its dtype.
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from feta_tmlr_tpu_torch.ops.kernels import build
from feta_tmlr_tpu_torch.ops.kernels.common import (
    bind,
    check_launch,
    check_operands,
    cuda_or_plain,
    plain_scores,
    ptr,
    rounded,
    stream_ptr,
    upcast,
)
from feta_tmlr_tpu_torch.ops.kernels.flash_attention import prepare
from feta_tmlr_tpu_torch.ops.kernels.modulation import (
    modulation_bwd_plain,
    modulation_fwd_plain,
)

MAX_NODES = 128     # a key row in a warp's registers; the backward's tiles
MAX_WIDTH = 64      # D: the staged rows hold 64 columns
MAX_CLUSTER = 8     # the portable thread-block cluster size
_fns = {}


def cluster_size(h: int) -> int:
    """CTAs of a graph's cluster for H heads, as the kernels launch them:
    the largest divisor of H that is at most `MAX_CLUSTER`; each CTA takes
    H / C consecutive heads (H = 8: one head a CTA; a prime H > 8: one CTA
    of all heads)."""
    return max(c for c in range(1, MAX_CLUSTER + 1) if h % c == 0)


def _kernel(name, suffix=""):
    """(lib, bound C function) for "fwd" or "bwd" at the operand dtypes
    that `suffix` names ("" float32, "_bf16")."""
    if (name, suffix) not in _fns:
        lib = build.load("fused_attention")
        n_ptrs = 10 if name == "fwd" else 16
        symbol = f"feta_fused_attn_{name}{suffix}"
        _fns[name, suffix] = (lib, bind(lib, symbol, n_ptrs, 4))
    return _fns[name, suffix]


def fused_attn_fwd_plain(xa, x, cq, ck, c0, vw, pe, deg, mask, inv_sqrt):
    """Dense version of the forward kernel: out [B, N, D]. From bf16
    operands: in float32, attn rounded to bf16, out to vw's dtype."""
    vdt = vw.dtype
    xa, x, vw = upcast(xa), upcast(x), upcast(vw)
    s = plain_scores(xa, x, cq, ck, c0, mask, inv_sqrt)
    attn = rounded(modulation_fwd_plain(s, pe, deg, mask), vdt)
    return (attn @ vw).sum(1).to(vdt)


def fused_attn_bwd_plain(xa, x, cq, ck, c0, vw, pe, deg, mask, inv_sqrt, g):
    """Dense version of the backward kernel: (dxa [B,H,N,D], dx [B,N,D],
    dcq [B,H,N], dck [B,H,N], dc0 [B,H], dvw [B,H,N,D]). From bf16
    operands: in float32, attn and ds rounded to bf16 before the products
    that take them (dcq, dck and dc0 sum ds unrounded), dxa, dx and dvw
    to vw's dtype."""
    vdt = vw.dtype
    xa, x, vw, g = upcast(xa), upcast(x), upcast(vw), upcast(g)
    s = plain_scores(xa, x, cq, ck, c0, mask, inv_sqrt)
    attn = rounded(modulation_fwd_plain(s, pe, deg, mask), vdt)
    g_h = g[:, None]                                   # every head's share
    ds = modulation_bwd_plain(s, pe, deg, mask,
                              g_h @ vw.transpose(-1, -2)) * inv_sqrt
    ds_c = rounded(ds, vdt)
    return ((ds_c @ x[:, None]).to(vdt),
            (ds_c.transpose(-1, -2) @ xa).sum(1).to(vdt), ds.sum(-1),
            ds.sum(-2), ds.sum((-1, -2)),
            (attn.transpose(-1, -2) @ g_h).to(vdt))


def _check(name, xa, x, cq, ck, c0, vw, pe, deg, mask, extra=()):
    """Shapes and dtypes (`check_operands`; bf16 values with float32 pe
    and deg, or all float32); returns (B, H, N, D), the C entry point's
    dtype suffix and the values' dtype."""
    b, h, n, d = xa.shape
    vdt, _ = check_operands(name, xa, x, cq, ck, c0, pe, deg, mask,
                            extra=[("vw", vw, (b, h, n, d)), *extra],
                            entry="fused_graphit_attention (FusedGraphiT)",
                            bf16=True, f32_modulation=True)
    if n > MAX_NODES:
        raise ValueError(f"{name}: N={n} > {MAX_NODES}; the fused kernels "
                         "hold a query's key row in registers and a graph's "
                         "[N, N] tiles in shared memory (the flash route "
                         "takes any N)")
    if d > MAX_WIDTH:
        raise ValueError(f"{name}: D={d} > {MAX_WIDTH}")
    return (b, h, n, d), ("_bf16" if vdt == torch.bfloat16 else ""), vdt


def fused_attn_fwd(xa, x, cq, ck, c0, vw, pe, deg, mask, inv_sqrt):
    """out [B, N, D] = sum_h attn_h @ vw_h (operand layout in `common`;
    vw [B, H, N, D])."""
    if not cuda_or_plain("fused_attn_fwd", xa):
        return fused_attn_fwd_plain(xa, x, cq, ck, c0, vw, pe, deg, mask,
                                    inv_sqrt)
    (b, h, n, d), suffix, vdt = _check("fused_attn_fwd", xa, x, cq, ck, c0,
                                       vw, pe, deg, mask)
    lib, fn = _kernel("fwd", suffix)
    out = torch.empty((b, n, d), dtype=vdt, device=xa.device)
    err = fn(ptr(xa), ptr(x), ptr(cq), ptr(ck), ptr(c0), ptr(vw), ptr(pe),
             ptr(deg), ptr(mask), ptr(out), b, h, n, d, float(inv_sqrt),
             stream_ptr(xa.device))
    check_launch(lib, err, "fused_attn_fwd")
    fused_attn_fwd.launches += 1
    return out


def fused_attn_bwd(xa, x, cq, ck, c0, vw, pe, deg, mask, inv_sqrt, g):
    """Gradients of out from its cotangent g [B, N, D]: (dxa, dx, dcq, dck,
    dc0 [B, H], dvw)."""
    args = (xa, x, cq, ck, c0, vw, pe, deg, mask, inv_sqrt, g)
    if not cuda_or_plain("fused_attn_bwd", xa):
        return fused_attn_bwd_plain(*args)
    (b, h, n, d), suffix, vdt = _check("fused_attn_bwd", *args[:9],
                                       extra=[("g", g, tuple(x.shape))])
    lib, fn = _kernel("bwd", suffix)
    dev = xa.device
    new = lambda dt, *shape: torch.empty(shape, dtype=dt, device=dev)
    f32 = torch.float32
    outs = (new(vdt, b, h, n, d), new(vdt, b, n, d), new(f32, b, h, n),
            new(f32, b, h, n), new(f32, b, h), new(vdt, b, h, n, d))
    err = fn(*(ptr(t) for t in args[:9]), ptr(g), *(ptr(t) for t in outs),
             b, h, n, d, float(inv_sqrt), stream_ptr(dev))
    check_launch(lib, err, "fused_attn_bwd")
    fused_attn_bwd.launches += 1
    return outs


fused_attn_fwd.launches = 0
fused_attn_bwd.launches = 0


class FusedGraphiT(torch.autograd.Function):
    """out = fused_attn_fwd(...) with its backward through
    `fused_attn_bwd`, each gradient in its input's dtype; pe, deg and the
    mask are data."""

    @staticmethod
    def forward(ctx, xa, x, cq, ck, c0, vw, pe, deg, mask, inv_sqrt):
        out = fused_attn_fwd(xa, x, cq, ck, c0, vw, pe, deg, mask, inv_sqrt)
        ctx.save_for_backward(xa, x, cq, ck, c0, vw, pe, deg, mask)
        ctx.inv_sqrt = inv_sqrt
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        dxa, dx, dcq, dck, dc0, dvw = fused_attn_bwd(
            *ctx.saved_tensors, ctx.inv_sqrt, g.contiguous())
        return dxa, dx, dcq, dck, dc0.sum(0), dvw, None, None, None, None


def fused_graphit_attention(xa, x, cq, ck, c0, vw, node_mask, pe=None,
                            degree=None):
    """out [B, N, D] = sum_h modulated_attn_h @ vw_h, for N <= `MAX_NODES`
    on the card.

    xa [B,H,N,D] = x @ Wq_h Wk_h^T, x [B,N,D], cq/ck [B,N,H] rank-1 bias
    terms, c0 [H], vw [B,H,N,D] = v_h @ Wout_h, node_mask [B,N], optional
    pe [B,N,N] and degree [B,N] (absent: ones, rows renormalised). bf16
    xa (the bf16 compute policy): x and vw go in as bf16 too (JAX's
    `x.astype(xa.dtype)`), pe and degree as float32, and out is bf16."""
    ops = prepare(xa, x, cq, ck, c0, node_mask, pe, degree)
    return FusedGraphiT.apply(
        ops["xa"], ops["x"], ops["cq"], ops["ck"], ops["c0"],
        vw.to(ops["xa"].dtype).contiguous(), ops["pe"], ops["deg"],
        ops["mask"], ops["inv_sqrt"])
