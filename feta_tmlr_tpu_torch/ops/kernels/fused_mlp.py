"""Fused two-layer MLP y = dropout(relu(x @ w1 + b1)) @ w2 + b2.

Kernels: `csrc/fused_mlp.cu`, the H100 counterparts of the TPU kernels
`feta_tmlr_tpu/ops/pallas/fused_mlp.py::_fwd_kernel` and `::_bwd_kernel`.
Neither writes the [R, F] hidden field to device memory; the backward
recomputes it from x. Both run their products on the tensor cores in
3xTF32, and the source note says what bounds them: `mma.sync`'s TF32
rate, beside the dropout hash on the integer lanes. The forward keeps a
slab of hidden units' weights resident in shared memory (the whole F of
the SAN head) and walks strips of rows with a persistent grid, a block an
SM, so there is no tail wave; pre, the keep bit and h are taken in the
products' registers. The backward is one pass per slab of hidden units
and split of rows, computing pre, g @ w2.T and the keep bit once per
(row, unit). Sums are in a fixed order, with no atomics.

`fused_mlp_fwd` and `fused_mlp_bwd` are the wrappers: on a CUDA tensor each
launches its kernel and counts the call in its `launches` attribute (the
backward's one call is two launches: the pass, then the sum of its split
and slab partials; the forward's is two where F spans more than one slab:
at width 16 and F = 2048, the PATTERN and molhiv eigen-PE heads); on a
CPU tensor each runs its plain version (`fused_mlp_plain`,
`fused_mlp_bwd_plain`). There is no other route and no
fallback. `FusedMLP` is the `torch.autograd.Function` that ties them
together, and `fused_mlp` the entry point.

Dropout: the keep bit of (row r, hidden unit j) is a hash of (seed, r, j)
below `keep_threshold(rate)`, the same bits in the kernel and in
`dropout_keep` (integer tensor ops), so the mask is independent of the
kernel's tiling, the backward regenerates the forward's mask, and kernel and
plain version agree bit for bit. The TPU kernel's PRNG bits cannot be
reproduced on the card; only rate 0 is comparable to the JAX package.

bf16 operands (the bf16 compute policy, `config.py`): both kernels also
take x, w1, w2 and g in bf16 with float32 b1 and b2 (their `_bf16` entry
points), as the SAN eigen-PE head hands them to the TPU kernels; y and dx
are bf16, the weight gradients float32, which `FusedMLP` rounds once to
the weights' dtype (JAX's custom VJP). The plain versions compute from
such operands in float32 and round where the JAX kernels cast: the hidden
row before its product with w2, dh before dx and dW1, the dropped hidden
row before dW2; then each output once to its dtype.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
from torch.autograd.function import once_differentiable

from feta_tmlr_tpu_torch.ops.kernels import build
from feta_tmlr_tpu_torch.ops.kernels.common import (
    check_launch,
    cuda_or_plain,
    ptr,
    rounded,
    stream_ptr,
    upcast,
)

_MASK32 = 0xFFFFFFFF
_GOLDEN = 0x9E3779B9
_fns = {}


def _kernel(name, suffix=""):
    """(lib, bound C function) for "fwd", "slabs", "bwd" or "grid", each
    bound at its first use; `suffix` ("" float32, "_bf16") names the
    operand dtypes of "fwd" and "bwd"."""
    if (name, suffix) not in _fns:
        lib = build.load("fused_mlp")
        p, i, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
        sym, argtypes = {
            "fwd": ("feta_fused_mlp_fwd",
                    [p] * 7 + [i] * 6 + [u, u, ctypes.c_float, p]),
            "slabs": ("feta_fused_mlp_fwd_slabs", [i] * 3),
            "bwd": ("feta_fused_mlp_bwd",
                    [p] * 9 + [i] * 6 + [u, u, ctypes.c_float, p]),
            "grid": ("feta_fused_mlp_bwd_grid",
                     [i] * 5 + [ctypes.POINTER(i)])}[name]
        fn = getattr(lib, sym + suffix)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        lib.feta_cuda_error_string.argtypes = [ctypes.c_int]
        lib.feta_cuda_error_string.restype = ctypes.c_char_p
        _fns[name, suffix] = (lib, fn)
    return _fns[name, suffix]


def keep_threshold(rate: float) -> int:
    """Hash values below this keep their unit: P(keep) = 1 - rate (the TPU
    kernel's `_keep_threshold`)."""
    return min(int(round((1.0 - rate) * 2.0 ** 32)), 2 ** 32 - 1)


def _mul32(x, c: int):
    """(x * c) mod 2^32 for uint32 values held in int64 tensors (or Python
    ints), without int64 overflow: x is split into 16-bit halves."""
    lo, hi = x & 0xFFFF, x >> 16
    return (lo * c + ((hi * (c & 0xFFFF)) << 16)) & _MASK32


def mix32(x):
    """The lowbias32 integer mixer of `csrc/fused_mlp.cu`, on int64 tensors
    or Python ints."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def dropout_keep(seed: int, rows: int, units: int, rate: float,
                 device=None) -> torch.Tensor:
    """Bool [rows, units] keep mask of the kernels' dropout. The seed's key
    is mixed on the host, so nothing is copied to the device (no sync);
    the mask costs ~45 elementwise launches."""
    key = mix32((seed & _MASK32) ^ _GOLDEN)
    r = torch.arange(rows, dtype=torch.int64, device=device)
    j = torch.arange(units, dtype=torch.int64, device=device)
    h = mix32(mix32(r ^ key)[:, None] ^ j[None, :])
    return h < keep_threshold(rate)


def _inv_keep(rate: float) -> float:
    """1 / (1 - rate) rounded to float32, the kernels' scale."""
    return float(torch.tensor(1.0 / (1.0 - rate), dtype=torch.float32))


def dropout_scale(seed, rows, units, rate, like):
    """keep / (1 - rate) as `like`'s dtype, or None at rate 0."""
    if rate <= 0.0:
        return None
    keep = dropout_keep(seed, rows, units, rate, like.device)
    return keep.to(like.dtype) * _inv_keep(rate)


def _check_seed(rate, seed):
    if rate > 0.0 and seed is None:
        raise ValueError("fused_mlp: dropout_rate > 0 requires a seed")
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"fused_mlp: dropout rate {rate} outside [0, 1)")
    return 0 if seed is None else int(seed)


def fused_mlp_plain(x, w1, b1, w2, b2, rate: float = 0.0,
                    seed: Optional[int] = None) -> torch.Tensor:
    """Dense version of the forward kernel: addmm, relu, mask, addmm. From
    bf16 x, w1, w2: in float32, the hidden row rounded to bf16, y to x's
    dtype."""
    seed = _check_seed(rate, seed)
    vdt = x.dtype
    x, w1, w2 = upcast(x), upcast(w1), upcast(w2)
    h = torch.relu(torch.addmm(b1, x, w1))
    scale = dropout_scale(seed, x.shape[0], w1.shape[1], rate, h)
    if scale is not None:
        h = h * scale
    return torch.addmm(b2, rounded(h, vdt), w2).to(vdt)


def fused_mlp_bwd_plain(x, w1, b1, w2, g, rate: float = 0.0,
                        seed: Optional[int] = None):
    """Dense version of the backward kernels: (dx, dw1, db1, dw2, db2).
    From bf16 x, w1, w2, g: in float32, dh and the dropped hidden row
    rounded to bf16 before the products that take them (db1 sums dh
    unrounded), dx to x's dtype, the weight gradients float32."""
    seed = _check_seed(rate, seed)
    vdt = x.dtype
    x, w1, w2, g = upcast(x), upcast(w1), upcast(w2), upcast(g)
    pre = torch.addmm(b1, x, w1)
    scale = dropout_scale(seed, x.shape[0], w1.shape[1], rate, pre)
    hd = torch.relu(pre)
    dh = g @ w2.T
    if scale is not None:
        hd, dh = hd * scale, dh * scale
    dh = dh * (pre > 0).to(dh.dtype)
    dh_c = rounded(dh, vdt)
    return ((dh_c @ w1.T).to(vdt), x.T @ dh_c, dh.sum(0),
            rounded(hd, vdt).T @ g, g.sum(0))


_VALUES = ("x", "w1", "w2", "g")     # bf16 under the bf16 compute policy


def _check(name, x, w1, b1, w2, extra):
    """Raise unless every operand is a contiguous tensor on x's device of
    the kernels' shapes, all float32 or (the bf16 compute policy) x, w1,
    w2 and g bf16 with float32 biases, with widths <= 64 and fewer than
    2^31 rows: the kernels take the row index as an int, widen every
    offset from a row to size_t before multiplying it, and never form an
    R x F index (the hidden field is not stored; R * F passes 2^31 at the
    edge eigen-PE head of a 128-graph chunk). Returns (R, din, F,
    dout)."""
    r, din = x.shape
    f, dout = w2.shape
    vdt = _values_dtype(x)[1]
    shapes = [("x", x, (r, din)), ("w1", w1, (din, f)), ("b1", b1, (f,)),
              ("w2", w2, (f, dout)), *extra]
    for key, t, shape in shapes:
        want = vdt if key in _VALUES else torch.float32
        if t.device != x.device or t.dtype != want:
            raise ValueError(f"{name}: {key} must be "
                             f"{str(want).replace('torch.', '')} on "
                             f"{x.device}, got {t.dtype} on {t.device}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: {key} has shape {tuple(t.shape)}, "
                             f"expected {tuple(shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
    if not (0 < din <= 64 and 0 < dout <= 64 and 0 < r < 2 ** 31
            and f > 0):
        raise ValueError(f"{name}: rows {r}, widths {din}/{dout} and hidden "
                         f"{f} must be positive, widths <= 64, rows below "
                         "2^31 (the kernels' row index is an int)")
    if torch.is_grad_enabled() and any(t.requires_grad for _, t, _ in shapes):
        raise RuntimeError(f"{name}: the raw kernel wrapper is not "
                           "differentiable; call it under torch.no_grad(), "
                           "or use fused_mlp (FusedMLP) for gradients")
    return r, din, f, dout


def _values_dtype(x):
    """(C entry point suffix, dtype) of the values x, w1, w2, g, y and dx:
    ("_bf16", bf16) for a bf16 x, else ("", float32)."""
    if x.dtype == torch.bfloat16:
        return "_bf16", torch.bfloat16
    return "", torch.float32


def _dropout_args(rate, seed):
    on = rate > 0.0
    return (int(on), (seed & _MASK32) if on else 0,
            keep_threshold(rate) if on else 0,
            _inv_keep(rate) if on else 1.0)


def fwd_slabs(din: int, f: int, dout: int) -> int:
    """The forward kernel's slabs of hidden units at these widths (16384 /
    D units a slab, D the width bucket of max(din, dout)): more than one
    means per-slab partials and a second launch. Asks the kernel's
    library, so it builds it."""
    return _kernel("slabs")[1](din, f, dout)


def fused_mlp_fwd(x, w1, b1, w2, b2, rate: float = 0.0,
                  seed: Optional[int] = None) -> torch.Tensor:
    """y [R, d_out] = dropout(relu(x @ w1 + b1)) @ w2 + b2. Where F spans
    more than one slab of the kernel's hidden units, one call is two
    launches: the pass, which writes a y partial per slab, then their sum
    in slab order with b2."""
    if not cuda_or_plain("fused_mlp_fwd", x):
        return fused_mlp_plain(x, w1, b1, w2, b2, rate, seed)
    seed = _check_seed(rate, seed)
    r, din, f, dout = _check("fused_mlp_fwd", x, w1, b1, w2,
                             [("b2", b2, (w2.shape[1],))])
    suffix, vdt = _values_dtype(x)
    dev = x.device
    n_slabs = fwd_slabs(din, f, dout)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    y = torch.empty((r, dout), dtype=vdt, device=dev)
    part = (torch.empty((n_slabs, r, dout), dtype=torch.float32, device=dev)
            if n_slabs > 1 else y)
    lib, fn = _kernel("fwd", suffix)
    err = fn(ptr(x), ptr(w1), ptr(b1), ptr(w2), ptr(b2), ptr(y), ptr(part),
             r, din, f, dout, n_sm, *_dropout_args(rate, seed),
             stream_ptr(dev))
    check_launch(lib, err, "fused_mlp_fwd")
    fused_mlp_fwd.launches += 1
    return y


fused_mlp_fwd.launches = 0


def fused_mlp_bwd(x, w1, b1, w2, g, rate: float = 0.0,
                  seed: Optional[int] = None):
    """(dx, dw1, db1, dw2, db2) of `fused_mlp_fwd` for the cotangent g
    [R, d_out]. One call is two launches from `csrc/fused_mlp.cu`: the pass
    over every (slab of hidden units, split of rows), which writes a dx
    partial per slab and a weight-gradient partial per split, then their
    sums in slab and split order."""
    if not cuda_or_plain("fused_mlp_bwd", x):
        return fused_mlp_bwd_plain(x, w1, b1, w2, g, rate, seed)
    seed = _check_seed(rate, seed)
    r, din, f, dout = _check("fused_mlp_bwd", x, w1, b1, w2,
                             [("g", g, (x.shape[0], w2.shape[1]))])
    suffix, vdt = _values_dtype(x)
    dev = x.device
    _, grid_fn = _kernel("grid")
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    n_slabs = ctypes.c_int(0)
    n_splits = grid_fn(r, din, f, dout, n_sm, ctypes.byref(n_slabs))
    n_slabs = n_slabs.value
    e = din * f + f + f * dout + dout
    dx = torch.empty((r, din), dtype=vdt, device=dev)
    part = torch.empty((n_splits, e), dtype=torch.float32, device=dev)
    grads = torch.empty((e,), dtype=torch.float32, device=dev)
    dx_part = torch.empty((n_slabs, r, din), dtype=torch.float32, device=dev)
    lib, fn = _kernel("bwd", suffix)
    err = fn(ptr(x), ptr(w1), ptr(b1), ptr(w2), ptr(g), ptr(dx), ptr(part),
             ptr(grads), ptr(dx_part), r, din, f, dout, n_splits,
             *_dropout_args(rate, seed), stream_ptr(dev))
    check_launch(lib, err, "fused_mlp_bwd")
    fused_mlp_bwd.launches += 1
    dw1, db1, dw2, db2 = grads.split([din * f, f, f * dout, dout])
    return dx, dw1.view(din, f), db1, dw2.view(f, dout), db2


fused_mlp_bwd.launches = 0


class FusedMLP(torch.autograd.Function):
    """y = fused_mlp_fwd(...) with a backward through fused_mlp_bwd, which
    recomputes the hidden field and regenerates the dropout mask from the
    seed (nothing of width F is saved). Each gradient is rounded once to
    its input's dtype (bf16 dW1 and dW2 under the bf16 policy, float32 db1
    and db2), as JAX's custom VJP rounds them."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, rate, seed):
        ctx.save_for_backward(x, w1, b1, w2)
        ctx.rate, ctx.seed, ctx.b2_dtype = rate, seed, b2.dtype
        return fused_mlp_fwd(x, w1, b1, w2, b2, rate, seed)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, w1, b1, w2 = ctx.saved_tensors
        dx, dw1, db1, dw2, db2 = fused_mlp_bwd(x, w1, b1, w2, g.contiguous(),
                                               ctx.rate, ctx.seed)
        return (dx, dw1.to(w1.dtype), db1.to(b1.dtype), dw2.to(w2.dtype),
                db2.to(ctx.b2_dtype), None, None)


def fused_mlp(x, w1, b1, w2, b2, dropout_rate: float = 0.0,
              seed: Optional[int] = None) -> torch.Tensor:
    """y = dropout(relu(x @ w1 + b1)) @ w2 + b2, differentiable.

    x [R, d_in]; w1 [d_in, F]; b1 [F]; w2 [F, d_out]; b2 [d_out]. `seed`
    (an int) drives the dropout mask and is required when dropout_rate > 0.
    Operands become contiguous in x's dtype, except that the biases of a
    bf16 x (the bf16 compute policy) become float32."""
    bdt = torch.float32 if x.dtype == torch.bfloat16 else x.dtype
    c = lambda t, dt=x.dtype: t.to(dt).contiguous()
    return FusedMLP.apply(x.contiguous(), c(w1), c(b1, bdt), c(w2),
                          c(b2, bdt), float(dropout_rate), seed)
