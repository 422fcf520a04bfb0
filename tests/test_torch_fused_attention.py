"""The port's fused attention wrappers vs the JAX package, on
the CPU.

On CPU tensors `fused_attn_fwd` / `fused_attn_bwd` run their plain
versions; these are held to the JAX Pallas kernels
(`feta_tmlr_tpu/ops/pallas/fused_attention.py`) run in interpret mode: the
forward, the raw backward kernel's six outputs (dc0 per graph and head),
and the gradients of the public entry point, with and without pe/degree,
with padded queries and keys, and with query rows in the |denom| <= 1e-9
branch. The fused route computes the same function as the online-softmax
(flash) route, so the two are also held to each other. The CUDA kernels
are held to the plain versions by `tests/test_torch_cuda.py` and
`chip_smoke.py` on the card.

Tolerance: rtol 1e-4 / atol 1e-5 (f32, sums in other orders), as for the
flash kernels (tests/test_torch_kernels.py); gradients of the entry point
rtol 1e-4 / atol 2e-5 (one more f32 reduction over the keys).
"""

import numpy as np
import pytest
import torch

import jax
import jax.experimental.pallas as pl
import jax.numpy as jnp

from feta_tmlr_tpu.ops.pallas import fused_attention as jfa
from feta_tmlr_tpu_torch.ops.kernels import fused_attention as tfa
from feta_tmlr_tpu_torch.ops.kernels import flash_attention as tfl

TOL = dict(rtol=1e-4, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=2e-5)
NAMES = ("xa", "x", "cq", "ck", "c0", "vw")


@pytest.fixture
def interpret_mode(monkeypatch):
    orig = pl.pallas_call
    monkeypatch.setattr(jfa.pl, "pallas_call",
                        lambda *a, **k: orig(*a, interpret=True, **k))


def _inputs(seed=0, b=3, h=2, n=20, d=16, guard_rows=3):
    """Public-layout operands; graph 0 loses 5 nodes and graph 2 loses 8;
    pe is 0 on the first `guard_rows` query rows of graph 1 (guard branch
    when pe is given); a cotangent g [B, N, D]."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    mask = np.ones((b, n), bool)
    mask[0, n - 5:] = False
    mask[2, n - 8:] = False
    pe = (rng.random((b, n, n)) * mask[:, :, None]
          * mask[:, None, :]).astype(np.float32)
    pe[1, :guard_rows] = 0.0
    deg = (rng.random((b, n)) * mask).astype(np.float32)
    return dict(xa=0.5 * f(b, h, n, d), x=0.5 * f(b, n, d), cq=f(b, n, h),
                ck=f(b, n, h), c0=f(h), vw=f(b, h, n, d), mask=mask, pe=pe,
                deg=deg, g=f(b, n, d))


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _mod(inp, with_mod):
    return ((inp["pe"], inp["deg"]) if with_mod else (None, None))


def _port(inp, with_mod, fn=tfa.fused_graphit_attention, grad=False):
    pe, deg = _mod(inp, with_mod)
    args = [_t(inp[k]) for k in NAMES]
    if grad:
        args = [a.requires_grad_() for a in args]
    out = fn(*args[:5], args[5], _t(inp["mask"]), pe=_t(pe), degree=_t(deg))
    return out, args


def _jax(inp, with_mod):
    pe, deg = _mod(inp, with_mod)
    kw = dict(pe=None if pe is None else jnp.asarray(pe),
              degree=None if deg is None else jnp.asarray(deg))
    mask = jnp.asarray(inp["mask"])
    fn = lambda *a: jfa.fused_graphit_attention(*a, mask, **kw)
    return fn, tuple(jnp.asarray(inp[k]) for k in NAMES)


@pytest.mark.parametrize("with_mod", [True, False])
def test_fused_forward_matches_jax_kernel(with_mod, interpret_mode):
    inp = _inputs(seed=1)
    fn, jargs = _jax(inp, with_mod)
    got, _ = _port(inp, with_mod)
    np.testing.assert_allclose(got.numpy(), np.asarray(fn(*jargs)), **TOL)


@pytest.mark.parametrize("with_mod", [True, False])
def test_fused_backward_kernel_matches_jax(with_mod, interpret_mode):
    """The plain backward's raw outputs vs the JAX `_call_bwd` in its
    kernel layout: dxa, dx, dcq [B,H,N,1], dck [B,H,1,N], dc0 [B,H,1,1]
    (before the sum over graphs), dvw."""
    inp = _inputs(seed=2)
    pe, deg = _mod(inp, with_mod)
    b, h, n, d = inp["xa"].shape
    j = {k: jnp.asarray(v) for k, v in inp.items()}
    f32 = jnp.float32
    want = jfa._call_bwd(
        j["xa"], j["x"], j["cq"].transpose(0, 2, 1)[..., None],
        j["ck"].transpose(0, 2, 1)[:, :, None, :], j["c0"].reshape(h, 1, 1),
        j["vw"], jnp.asarray(pe) if with_mod else jnp.ones((b, n, n), f32),
        (jnp.asarray(deg) if with_mod else jnp.ones((b, n), f32)
         ).reshape(b, 1, n),
        j["mask"].astype(f32).reshape(b, n, 1),
        j["mask"].astype(f32).reshape(b, 1, n),
        jnp.full((1, 1), 1.0 / (d // h) ** 0.5, f32), j["g"])
    ops = tfl.prepare(*(_t(inp[k]) for k in NAMES[:5]), _t(inp["mask"]),
                      _t(pe), _t(deg))
    got = tfa.fused_attn_bwd(vw=_t(inp["vw"]), g=_t(inp["g"]), **ops)
    shapes = [(b, h, n, d), (b, n, d), (b, h, n), (b, h, n), (b, h),
              (b, h, n, d)]
    for name, gt, w, shape in zip(("dxa", "dx", "dcq", "dck", "dc0", "dvw"),
                                  got, want, shapes):
        np.testing.assert_allclose(gt.numpy(),
                                   np.asarray(w).reshape(shape),
                                   err_msg=name, **TOL)


@pytest.mark.parametrize("with_mod", [True, False])
def test_fused_gradients_match_jax(with_mod, interpret_mode):
    """Gradients of the entry point (`FusedGraphiT`, plain backward) vs
    jax.vjp through the JAX custom VJP, w.r.t. all six operands."""
    inp = _inputs(seed=3)
    fn, jargs = _jax(inp, with_mod)
    _, vjp = jax.vjp(fn, *jargs)
    want = vjp(jnp.asarray(inp["g"]))
    out, args = _port(inp, with_mod, grad=True)
    out.backward(_t(inp["g"]))
    for name, a, w in zip(NAMES, args, want):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(w),
                                   err_msg=name, **GRAD_TOL)


@pytest.mark.parametrize("with_mod", [True, False])
def test_fused_and_flash_routes_agree(with_mod):
    """One function, two designs: the fused route and the online-softmax
    route agree, forward and gradients, on the CPU's plain versions."""
    inp = _inputs(seed=4)
    outs, grads = [], []
    for fn in (tfa.fused_graphit_attention, tfl.flash_graphit_attention):
        out, args = _port(inp, with_mod, fn=fn, grad=True)
        out.backward(_t(inp["g"]))
        outs.append(out.detach())
        grads.append([a.grad for a in args])
    np.testing.assert_allclose(outs[0].numpy(), outs[1].numpy(), **TOL)
    for name, a, b in zip(NAMES, *grads):
        np.testing.assert_allclose(a.numpy(), b.numpy(), err_msg=name,
                                   **GRAD_TOL)


def test_fused_backward_plain_matches_float64_autograd():
    """The plain backward, guard rows included, equals float64 autograd of
    the plain forward (exact up to float64 rounding)."""
    inp = _inputs(seed=5)
    ops = tfl.prepare(*(_t(inp[k]).double() for k in NAMES[:5]),
                      _t(inp["mask"]), _t(inp["pe"]).double(),
                      _t(inp["deg"]).double())
    keys = ("xa", "x", "cq", "ck", "c0")
    leaves = {k: ops[k].clone().requires_grad_() for k in keys}
    vw = _t(inp["vw"]).double().requires_grad_()
    g = _t(inp["g"]).double()
    rest = dict(pe=ops["pe"], deg=ops["deg"], mask=ops["mask"],
                inv_sqrt=ops["inv_sqrt"])
    tfa.fused_attn_fwd_plain(vw=vw, **leaves, **rest).backward(g)
    got = tfa.fused_attn_bwd_plain(vw=vw.detach(), g=g, **rest,
                                   **{k: ops[k] for k in keys})
    want = [leaves[k].grad for k in keys] + [vw.grad]
    got = list(got[:4]) + [got[4].sum(0), got[5]]
    for name, a, w in zip(NAMES, got, want):
        np.testing.assert_allclose(a.numpy(), w.numpy(), rtol=1e-9,
                                   atol=1e-11, err_msg=name)


def test_cpu_takes_no_kernel_and_no_node_limit():
    """The N <= 128 limit is the CUDA kernels' (shared memory); the CPU's
    plain version takes any N and counts no launch."""
    inp = _inputs(seed=6, n=tfa.MAX_NODES + 3, d=8)
    before = tfa.fused_attn_fwd.launches, tfa.fused_attn_bwd.launches
    out, args = _port(inp, True, grad=True)
    out.backward(_t(inp["g"]))
    assert torch.isfinite(out).all()
    assert (tfa.fused_attn_fwd.launches, tfa.fused_attn_bwd.launches) == \
        before
