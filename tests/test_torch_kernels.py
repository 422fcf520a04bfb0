"""Attention kernels of the port vs the JAX package.

On the CPU the wrappers take their plain PyTorch versions; those are held
to the JAX Pallas kernels run in interpret mode (monkeypatched as in
tests/test_flash_need_heads.py) and to the dense modulation chain. The
CUDA kernels themselves are held to the plain versions by the `cuda`-marked
tests in tests/test_torch_cuda.py, which need a card, and by chip_smoke.py.

Tolerance: rtol 1e-4, atol 1e-5 (f32; the two sides sum in different
orders and the JAX kernel's online rescaling rounds differently); for
gradients through the whole attention rtol 1e-4, atol 2e-5 (one more
f32 reduction over the keys).
"""

import numpy as np
import pytest
import torch

import jax
import jax.experimental.pallas as pl
import jax.numpy as jnp

from feta_tmlr_tpu.ops.pallas import flash_attention as jfl
from feta_tmlr_tpu_torch.ops.attention import modulated_attention_from_scores
from feta_tmlr_tpu_torch.ops.kernels import colstat as tcs
from feta_tmlr_tpu_torch.ops.kernels import flash_attention as tfl
from feta_tmlr_tpu_torch.ops.kernels.common import bwd_row_constants
from feta_tmlr_tpu_torch.ops.laplacian import gcn_norm_directed

TOL = dict(rtol=1e-4, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=2e-5)


@pytest.fixture
def interpret_mode(monkeypatch):
    orig = pl.pallas_call
    monkeypatch.setattr(jfl.pl, "pallas_call",
                        lambda *a, **k: orig(*a, interpret=True, **k))


def _inputs(seed=0, b=2, h=2, n=32, d=8, dv=8, pad=5):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    xa, x, vw = f(b, h, n, d), f(b, n, d), f(b, h, n, dv)
    cq, ck, c0 = f(b, n, h), f(b, n, h), f(h)
    mask = np.ones((b, n), bool)
    if pad:
        mask[0, n - pad:] = False
    pe = (rng.random((b, n, n)) * mask[:, :, None]
          * mask[:, None, :]).astype(np.float32)
    deg = (rng.random((b, n)) * mask).astype(np.float32)
    return dict(xa=xa, x=x, cq=cq, ck=ck, c0=c0, vw=vw, mask=mask, pe=pe,
                deg=deg)


def _t(a):
    return torch.from_numpy(np.array(a))


def _port_args(inp, with_mod):
    return (_t(inp["xa"]), _t(inp["x"]), _t(inp["cq"]), _t(inp["ck"]),
            _t(inp["c0"]), _t(inp["vw"]), _t(inp["mask"]),
            _t(inp["pe"]) if with_mod else None,
            _t(inp["deg"]) if with_mod else None)


def _jax_args(inp, with_mod):
    j = {k: jnp.asarray(v) for k, v in inp.items()}
    return ((j["xa"], j["x"], j["cq"], j["ck"], j["c0"], j["vw"],
             j["mask"]), dict(pe=j["pe"] if with_mod else None,
                              degree=j["deg"] if with_mod else None))


def _dense_chain(xa, x, cq, ck, c0, v, mask, pe, deg):
    """Port's dense specification: scores -> modulated attention."""
    h, d = xa.shape[1], xa.shape[-1]
    s = (torch.einsum("bhng,bmg->bhnm", xa, x)
         + cq.transpose(1, 2)[..., None] + ck.transpose(1, 2)[:, :, None]
         + c0[None, :, None, None]) / (d // h) ** 0.5
    return modulated_attention_from_scores(s, v, mask, pe=pe, degree=deg)


@pytest.mark.parametrize("with_mod", [True, False])
@pytest.mark.parametrize("block", [8, 32])
def test_flash_graphit_attention_matches_jax(with_mod, block,
                                             interpret_mode):
    inp = _inputs(seed=1, d=8, dv=8)
    jargs, jkw = _jax_args(inp, with_mod)
    want = jfl.flash_graphit_attention(*jargs, block_q=block, block_k=block,
                                       **jkw)
    args = _port_args(inp, with_mod)
    got = tfl.flash_graphit_attention(*args[:7], pe=args[7], degree=args[8])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("with_mod", [True, False])
def test_flash_statistics_match_jax(with_mod, interpret_mode):
    inp = _inputs(seed=2, dv=4)
    jargs, jkw = _jax_args(inp, with_mod)
    xa, x, cq, ck, c0, vw, mask = jargs
    prep = jfl._prepare(xa, x, cq, ck, c0, mask, jkw["pe"], jkw["degree"],
                        None)
    pe_a, deg_a, qm, km, inv_sqrt, cq_k, ck_k, c0_k = prep
    want = jfl._call_fwd(xa, x, cq_k, ck_k, c0_k, vw, pe_a, deg_a, qm, km,
                         inv_sqrt, 8, 8)
    a = _port_args(inp, with_mod)
    ops = tfl.prepare(*a[:5], a[6], a[7], a[8])
    got = tfl.flash_fwd(vw=a[5], **ops)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), **TOL)
    for g, w in zip(got[1:], want[1:]):          # m, se, su
        np.testing.assert_allclose(g.numpy(), np.asarray(w)[..., 0], **TOL)


@pytest.mark.parametrize("with_mod", [True, False])
def test_flash_heads_and_colstat_match_jax(with_mod, interpret_mode):
    inp = _inputs(seed=3, dv=4)
    jargs, jkw = _jax_args(inp, with_mod)
    want_h, want_s = jfl.flash_graphit_attention_heads(
        *jargs, block_q=8, block_k=8, **jkw)
    a = _port_args(inp, with_mod)
    got_h, got_s = tfl.flash_graphit_attention_heads(
        *a[:7], pe=a[7], degree=a[8])
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), **TOL)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), **TOL)

    # the column-statistics pass on its own (pass 1: wq = 1)
    xa, x, cq, ck, c0, vw, mask = jargs
    pe_a, deg_a, qm, km, inv_sqrt, cq_k, ck_k, c0_k = jfl._prepare(
        xa, x, cq, ck, c0, mask, jkw["pe"], jkw["degree"], None)
    _, m, se, su = jfl._call_fwd(xa, x, cq_k, ck_k, c0_k, vw, pe_a, deg_a,
                                 qm, km, inv_sqrt, 8, 8)
    safe = jnp.where(jnp.abs(su / se) > 1e-9, su / se, 1.0)
    want_cs, want_dg = jfl._call_colstat(
        xa, x, cq_k, ck_k, c0_k, pe_a, deg_a, qm, km, inv_sqrt, m, 1.0 / se,
        qm[:, None] / safe, jnp.ones_like(m), 8, 8)
    ops = tfl.prepare(*a[:5], a[6], a[7], a[8])
    sq = lambda t: _t(np.asarray(t)[..., 0])
    cs, dg = tcs.colstat(m=sq(m), se=sq(se), su=sq(su), **ops)
    np.testing.assert_allclose(cs.numpy(), np.asarray(want_cs)[:, :, 0],
                               **TOL)
    np.testing.assert_allclose(dg.numpy(), np.asarray(want_dg)[:, :, 0],
                               **TOL)


@pytest.mark.parametrize("n,pad", [(13, 3), (40, 0)])
def test_plain_kernels_match_dense_chain(n, pad):
    """Plain versions vs the dense modulation chain at ragged sizes."""
    inp = _inputs(seed=4, n=n, pad=pad, d=8, dv=8)
    xa, x, cq, ck, c0, vw, mask, pe, deg = _port_args(inp, True)
    heads_ref, attn = _dense_chain(xa, x, cq, ck, c0, vw, mask, pe, deg)
    got = tfl.flash_graphit_attention(xa, x, cq, ck, c0, vw, mask, pe=pe,
                                      degree=deg)
    np.testing.assert_allclose(got.numpy(), heads_ref.sum(1).numpy(), **TOL)
    got_h, got_s = tfl.flash_graphit_attention_heads(
        xa, x, cq, ck, c0, vw, mask, pe=pe, degree=deg)
    np.testing.assert_allclose(got_h.numpy(),
                               heads_ref.transpose(1, 2).numpy(), **TOL)
    s_ref = gcn_norm_directed(attn, mask[:, None, :]).sum(2)
    np.testing.assert_allclose(got_s.numpy(), s_ref.numpy(), **TOL)


def test_wrappers_count_only_kernel_launches():
    inp = _inputs(seed=5)
    a = _port_args(inp, True)
    tfl.flash_fwd.launches = tcs.colstat.launches = 0
    tfl.flash_graphit_attention_heads(*a[:7], pe=a[7], degree=a[8])
    assert tfl.flash_fwd.launches == 0 and tcs.colstat.launches == 0
    with pytest.raises(ValueError, match="unsupported device"):
        tfl.flash_fwd(*(t.to("meta") if t is not None else None
                        for t in a[:6]), a[7], a[8], a[6], 1.0)


def test_heads_signal_is_detached():
    inp = _inputs(seed=6)
    a = [t.requires_grad_() if t is not None and t.is_floating_point()
         and i < 6 else t for i, t in enumerate(_port_args(inp, True))]
    heads, s = tfl.flash_graphit_attention_heads(
        *a[:7], pe=a[7], degree=a[8])
    assert heads.requires_grad and not s.requires_grad



# ---------------------------------------------------------------- backward

def _guarded(inp):
    """pe zero on the first 6 query rows of graph 1: su = 0 there, so
    those rows take the |su/se| <= 1e-9 branch of forward and backward."""
    inp = dict(inp)
    inp["pe"] = inp["pe"].copy()
    inp["pe"][1, :6] = 0.0
    return inp


@pytest.mark.parametrize("case", ["mod", "plain", "guard"])
def test_flash_bwd_plain_matches_jax_call_bwd(case, interpret_mode):
    """Both backward passes (row constants included) vs the JAX package's
    `_bwd_common`, which runs kernels #3/#4 (`_call_bwd`) at block 8; in
    the guard case su is also zeroed on 5 rows of graph 0 on both sides,
    so the branch runs with c = r != 0."""
    inp = _inputs(seed=10, dv=4)
    if case == "guard":
        inp = _guarded(inp)
    with_mod = case != "plain"
    jargs, jkw = _jax_args(inp, with_mod)
    xa, x, cq, ck, c0, vw, mask = jargs
    pe_a, deg_a, qm, km, inv_sqrt, cq_k, ck_k, c0_k = jfl._prepare(
        xa, x, cq, ck, c0, mask, jkw["pe"], jkw["degree"], None)
    outh, m, se, su = jfl._call_fwd(xa, x, cq_k, ck_k, c0_k, vw, pe_a,
                                    deg_a, qm, km, inv_sqrt, 8, 8)
    if case == "guard":
        su = su.at[0, :, :5].set(0.0)
    g = np.random.default_rng(11).standard_normal(
        outh.shape).astype(np.float32)
    res = (xa, x, cq_k, ck_k, c0_k, vw, pe_a, deg_a, qm, km, inv_sqrt,
           outh, m, se, su)
    w_dxa, w_dx, w_dcq, w_dck, w_dc0, w_dvw = jfl._bwd_common(
        res, jnp.asarray(g), 8, 8)[:6]

    a = _port_args(inp, with_mod)
    ops = tfl.prepare(*a[:5], a[6], a[7], a[8])
    sq = lambda t: _t(np.asarray(t)[..., 0])
    consts = bwd_row_constants(_t(g), _t(outh), sq(se), sq(su), ops["mask"])
    if case == "guard":
        assert float(consts[3].abs().max()) > 1e-3       # c != 0 runs
    got = tfl.flash_bwd(ops["xa"], ops["x"], ops["cq"], ops["ck"], ops["c0"],
                        a[5], ops["pe"], ops["deg"], ops["mask"],
                        ops["inv_sqrt"], _t(g), sq(m), *consts)
    dxa, dcq, dvw, dck, dx = (t.numpy() for t in got)
    np.testing.assert_allclose(dxa, np.asarray(w_dxa), **TOL)
    np.testing.assert_allclose(dcq, np.asarray(w_dcq)[..., 0], **TOL)
    np.testing.assert_allclose(dvw, np.asarray(w_dvw), **TOL)
    np.testing.assert_allclose(dck, np.asarray(w_dck)[:, :, 0], **TOL)
    np.testing.assert_allclose(dx, np.asarray(w_dx), **TOL)
    np.testing.assert_allclose(dcq.sum((0, 2)), np.asarray(w_dc0).ravel(),
                               **TOL)


@pytest.mark.parametrize("case", ["mod", "plain", "guard"])
def test_flash_bwd_plain_matches_autograd_of_forward(case):
    """The closed-form backward vs torch.autograd through the dense
    forward, an independent derivation."""
    inp = _inputs(seed=12, n=24, dv=4)
    if case == "guard":
        inp = _guarded(inp)
    a = _port_args(inp, case != "plain")
    ops = tfl.prepare(*a[:5], a[6], a[7], a[8])
    leaves = {k: ops[k].clone().requires_grad_()
              for k in ("xa", "x", "cq", "ck", "c0")}
    vw = a[5].clone().requires_grad_()
    rest = dict(pe=ops["pe"], deg=ops["deg"], mask=ops["mask"],
                inv_sqrt=ops["inv_sqrt"])
    outh, m, se, su = tfl.flash_fwd_plain(vw=vw, **leaves, **rest)
    g = _t(np.random.default_rng(13).standard_normal(
        tuple(outh.shape)).astype(np.float32))
    (outh * g).sum().backward()
    consts = bwd_row_constants(g, outh.detach(), se.detach(), su.detach(),
                               ops["mask"])
    got = tfl.flash_bwd(*(ops[k] for k in ("xa", "x", "cq", "ck", "c0")),
                        a[5], ops["pe"], ops["deg"], ops["mask"],
                        ops["inv_sqrt"], g, m.detach(), *consts)
    want = (leaves["xa"].grad, leaves["cq"].grad, vw.grad,
            leaves["ck"].grad, leaves["x"].grad)
    for name, gt, wt in zip(("dxa", "dcq", "dvw", "dck", "dx"), got, want):
        np.testing.assert_allclose(gt.numpy(), wt.numpy(), err_msg=name,
                                   **TOL)
    np.testing.assert_allclose(got[1].sum((0, 2)).numpy(),
                               leaves["c0"].grad.numpy(), **TOL)


@pytest.mark.parametrize("heads", [False, True])
@pytest.mark.parametrize("case", ["mod", "plain", "guard"])
def test_flash_attention_grads_match_jax(heads, case, interpret_mode):
    """Gradients of both public entry points (through `FlashGraphiT`) vs
    jax.grad of the JAX functions, whose backward runs kernels #3/#4
    interpreted at block 8."""
    inp = _inputs(seed=14, dv=4 if heads else 8)
    if case == "guard":
        inp = _guarded(inp)
    with_mod = case != "plain"
    jargs, jkw = _jax_args(inp, with_mod)
    rng = np.random.default_rng(15)
    b, h, n, _ = inp["xa"].shape
    dv = inp["vw"].shape[-1]
    g = rng.standard_normal((b, n, h, dv) if heads else (b, n, 8)
                            ).astype(np.float32)

    def jloss(*diff):
        args = diff + jargs[6:]
        if heads:
            out, _ = jfl.flash_graphit_attention_heads(
                *args, block_q=8, block_k=8, **jkw)
        else:
            out = jfl.flash_graphit_attention(*args, block_q=8, block_k=8,
                                              **jkw)
        return (out * g).sum()

    want = jax.grad(jloss, argnums=tuple(range(6)))(*jargs[:6])
    a = list(_port_args(inp, with_mod))
    diff = [t.requires_grad_() for t in a[:6]]
    if heads:
        out, s = tfl.flash_graphit_attention_heads(*a[:7], pe=a[7],
                                                   degree=a[8])
        assert not s.requires_grad
    else:
        out = tfl.flash_graphit_attention(*a[:7], pe=a[7], degree=a[8])
    (out * _t(g)).sum().backward()
    for name, t, w in zip(("xa", "x", "cq", "ck", "c0", "vw"), diff, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w),
                                   err_msg=name, **GRAD_TOL)
