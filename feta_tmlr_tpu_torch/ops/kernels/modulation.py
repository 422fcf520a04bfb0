"""GraphiT attention modulation on precomputed scores, forward and backward.

Kernels: `csrc/modulation.cu`, the H100 counterparts of the TPU kernels
`feta_tmlr_tpu/ops/pallas/modulation.py::_fwd_kernel` and `::_bwd_kernel`.
The source note says what bounds them (bytes: one score in, one attention
value out) and how the design answers that (each row read once into the
registers of a team of threads that loops over the heads with pe * degree
held, masked cells never read; a streaming kernel past 8192 keys, so any N
works).

The function, per query row of scaled scores [B, H, N, N]: masked softmax
over the keys, times pe[i, j] * degree[j], renormalised over the keys (a
denominator with |denom| <= 1e-9 is replaced by 1), times the query and key
masks. Absent pe or degree count as ones and the row is renormalised all
the same, as the TPU kernel does (the dense chain
`ops/attention.py::modulated_attention_from_scores` skips the
renormalisation then; the two differ only by rounding). The backward gives
the gradient of the scores only: pe, degree and the masks are data.

`modulation_fwd` and `modulation_bwd` are the wrappers: on a CUDA tensor
each launches its kernel and counts the launch in its `launches` attribute;
on a CPU tensor each runs its plain version (`modulation_fwd_plain`,
`modulation_bwd_plain`), which also takes float64. There is no other route
and no fallback. `ModulatedAttention` is the `torch.autograd.Function` that
ties them together, and `fused_modulated_attention` the entry point.
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from feta_tmlr_tpu_torch.ops.kernels import build
from feta_tmlr_tpu_torch.ops.kernels.common import (
    EPS,
    NEG_INF,
    bind,
    check_f32,
    check_launch,
    cuda_or_plain,
    plain_pd,
    ptr,
    stream_ptr,
)

_fns = {}
WIDE_MAX = 512      # csrc/modulation.cu's kWideMax: the largest team


def team_geometry(n):
    """(T, V) of csrc/modulation.cu's `geometry` for N = n keys: a team of
    T threads holds a query row, V groups of 4 keys a thread (one up to 32
    groups, else four), T the least power of two that covers the groups;
    None past the register path (T > WIDE_MAX: the streaming kernels)."""
    groups = (n + 3) // 4
    v = 1 if groups <= 32 else 4
    t = 1
    while t * v < groups:
        t *= 2
    return None if t > WIDE_MAX else (t, v)


def _kernel(name):
    """(lib, bound C function) for "fwd" or "bwd"."""
    if name not in _fns:
        lib = build.load("modulation")
        n_ptrs = 5 if name == "fwd" else 6
        _fns[name] = (lib, bind(lib, f"feta_modulation_{name}", n_ptrs, 3,
                                n_floats=0))
    return _fns[name]


def _chain(scores, pe, deg, mask):
    """The forward's intermediates: (a, pd, safe, guard, qk) with a the
    masked softmax, pd = pe * deg [B, 1, N, N], safe/guard [B, H, N, 1] and
    qk = qmask * kmask [B, 1, N, N]."""
    km = mask[:, None, None, :]
    s = torch.where(km > 0, scores, torch.full_like(scores, NEG_INF))
    e = torch.exp(s - s.amax(-1, keepdim=True))
    a = e / e.sum(-1, keepdim=True)
    pd = plain_pd(pe, deg, scores)
    denom = (a * pd).sum(-1, keepdim=True)
    on = denom.abs() > EPS
    safe = torch.where(on, denom, torch.ones_like(denom))
    return a, pd, safe, on.to(scores.dtype), mask[:, None, :, None] * km


def modulation_fwd_plain(scores, pe, deg, mask):
    """Dense version of the forward kernel: attn [B, H, N, N]."""
    a, pd, safe, _, qk = _chain(scores, pe, deg, mask)
    return a * pd / safe * qk


def modulation_bwd_plain(scores, pe, deg, mask, g):
    """Dense version of the backward kernel: d scores [B, H, N, N]."""
    a, pd, safe, guard, qk = _chain(scores, pe, deg, mask)
    gm = g * qk
    r = (gm * (a * pd)).sum(-1, keepdim=True)
    # where |denom| <= eps the forward divides by the constant 1, whose
    # derivative is the identity: du = g there, not 0
    du = gm / safe - (r / (safe * safe)) * guard
    da = du * pd
    return a * (da - (da * a).sum(-1, keepdim=True))


def _check(name, scores, pe, deg, mask, extra=()):
    b, h, n, n2 = scores.shape
    if n2 != n:
        raise ValueError(f"{name}: scores must be [B, H, N, N], got "
                         f"{tuple(scores.shape)}")
    check_f32(name, scores.device,
              [("scores", scores, (b, h, n, n)), ("pe", pe, (b, n, n)),
               ("deg", deg, (b, n)), ("mask", mask, (b, n)), *extra],
              "fused_modulated_attention (ModulatedAttention)")
    return b, h, n


def modulation_fwd(scores, pe, deg, mask):
    """attn [B, H, N, N] from scaled scores; pe [B, N, N] and deg [B, N]
    may be None, mask [B, N] is float (1 = real node)."""
    if not cuda_or_plain("modulation_fwd", scores):
        return modulation_fwd_plain(scores, pe, deg, mask)
    b, h, n = _check("modulation_fwd", scores, pe, deg, mask)
    lib, fn = _kernel("fwd")
    out = torch.empty_like(scores)
    err = fn(ptr(scores), ptr(pe), ptr(deg), ptr(mask), ptr(out), b, h, n,
             stream_ptr(scores.device))
    check_launch(lib, err, "modulation_fwd")
    modulation_fwd.launches += 1
    return out


def modulation_bwd(scores, pe, deg, mask, g):
    """d scores [B, H, N, N] from the cotangent g of attn."""
    if not cuda_or_plain("modulation_bwd", scores):
        return modulation_bwd_plain(scores, pe, deg, mask, g)
    b, h, n = _check("modulation_bwd", scores, pe, deg, mask,
                     extra=[("g", g, tuple(scores.shape))])
    lib, fn = _kernel("bwd")
    ds = torch.empty_like(scores)
    err = fn(ptr(scores), ptr(pe), ptr(deg), ptr(mask), ptr(g), ptr(ds), b,
             h, n, stream_ptr(scores.device))
    check_launch(lib, err, "modulation_bwd")
    modulation_bwd.launches += 1
    return ds


modulation_fwd.launches = 0
modulation_bwd.launches = 0


class ModulatedAttention(torch.autograd.Function):
    """attn = modulation_fwd(scores, ...), differentiable in the scores
    through `modulation_bwd`."""

    @staticmethod
    def forward(ctx, scores, pe, deg, mask):
        attn = modulation_fwd(scores, pe, deg, mask)
        ctx.save_for_backward(scores, pe, deg, mask)
        return attn

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        scores, pe, deg, mask = ctx.saved_tensors
        return (modulation_bwd(scores, pe, deg, mask, g.contiguous()), None,
                None, None)


def fused_modulated_attention(scores, node_mask, pe=None, degree=None):
    """attn [B, H, N, N] from scaled scores [B, H, N, N]: masked softmax,
    modulation by pe [B, N, N] and degree [B, N] (None: ones), row
    renormalisation and query/key masking. Differentiable in the scores;
    pe and degree are data. float64 scores keep float64 (the CPU's plain
    route; the CUDA kernels take float32 only)."""
    dt = torch.float64 if scores.dtype == torch.float64 else torch.float32
    cast = lambda t: None if t is None else t.detach().to(dt).contiguous()
    return ModulatedAttention.apply(scores.to(dt).contiguous(), cast(pe),
                                    cast(degree), cast(node_mask))
