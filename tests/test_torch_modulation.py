"""The port's modulation kernel wrappers vs the JAX package, on the CPU.

On CPU tensors `modulation_fwd` / `modulation_bwd` run their plain
versions; these are held to the JAX Pallas kernels
(`feta_tmlr_tpu/ops/pallas/modulation.py`) run in interpret mode, forward
and gradients, with and without pe and degree, with padded queries and
keys, and with rows in the |denom| <= 1e-9 branch (rows whose pe * degree
is 0 over every real key: there the gradient is du = g, not 0). The CUDA
kernels are held to the plain versions by `tests/test_torch_cuda.py` and
`chip_smoke.py` on the card.

Tolerance: forward rtol 1e-5 / atol 1e-6 (the same f32 chain, sums in
another order), the JAX package's own kernel-vs-twin bound; gradients
rtol 1e-4 / atol 1e-5 (three more f32 row sums).
"""

import numpy as np
import pytest
import torch

import jax
import jax.experimental.pallas as pl
import jax.numpy as jnp

from feta_tmlr_tpu.ops.pallas import modulation as jmod
from feta_tmlr_tpu_torch.ops.attention import modulated_attention_from_scores
from feta_tmlr_tpu_torch.ops.kernels import modulation as tmod

FWD_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
MOD_CASES = [(True, True), (True, False), (False, True), (False, False)]


@pytest.fixture
def interpret_mode(monkeypatch):
    orig = pl.pallas_call
    monkeypatch.setattr(jmod.pl, "pallas_call",
                        lambda *a, **k: orig(*a, interpret=True, **k))


def _inputs(seed=0, b=3, h=2, n=16, guard_rows=3):
    """Scores, mask (graph 0 loses 5 nodes, graph 2 loses 9), pe and
    degree over real nodes, and a cotangent. pe is 0 on the first
    `guard_rows` query rows of graph 1 and degree is 0 on every node of
    graph 2, so those rows take the guard branch when pe (resp. degree) is
    given."""
    rng = np.random.default_rng(seed)
    scores = rng.standard_normal((b, h, n, n)).astype(np.float32)
    mask = np.ones((b, n), bool)
    mask[0, n - 5:] = False
    mask[2, n - 9:] = False
    pe = (rng.random((b, n, n)) * mask[:, :, None]
          * mask[:, None, :]).astype(np.float32)
    pe[1, :guard_rows] = 0.0
    deg = (rng.random((b, n)) * mask).astype(np.float32)
    deg[2] = 0.0
    g = rng.standard_normal((b, h, n, n)).astype(np.float32)
    return scores, mask, pe, deg, g


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


def _guard_rows(pe, deg, mask):
    """Real query rows whose pe * degree vanishes over the real keys."""
    p = np.ones(mask.shape + mask.shape[-1:], np.float32)
    if pe is not None:
        p = p * pe
    if deg is not None:
        p = p * deg[:, None, :]
    return int(((p * mask[:, None, :]).sum(-1) == 0)[mask].sum())


@pytest.mark.parametrize("with_pe,with_deg", MOD_CASES)
def test_modulation_forward_matches_jax_kernel(with_pe, with_deg,
                                               interpret_mode):
    scores, mask, pe, deg, _ = _inputs()
    pe, deg = (pe if with_pe else None), (deg if with_deg else None)
    want = jmod.fused_modulated_attention(_j(scores), _j(mask), pe=_j(pe),
                                          degree=_j(deg))
    got = tmod.fused_modulated_attention(_t(scores), _t(mask), pe=_t(pe),
                                         degree=_t(deg))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD_TOL)
    if with_pe and with_deg:       # the dense chain renormalises here too
        _, dense = modulated_attention_from_scores(
            _t(scores), None, _t(mask), pe=_t(pe), degree=_t(deg))
        np.testing.assert_allclose(got.numpy(), dense.numpy(), **FWD_TOL)


@pytest.mark.parametrize("with_pe,with_deg", MOD_CASES)
def test_modulation_gradient_matches_jax_kernel(with_pe, with_deg,
                                                interpret_mode):
    """d scores through the port's `ModulatedAttention` (plain backward)
    vs jax.vjp through the JAX custom VJP (`_bwd_kernel`, interpreted)."""
    scores, mask, pe, deg, g = _inputs(seed=1)
    pe, deg = (pe if with_pe else None), (deg if with_deg else None)
    n_guard = _guard_rows(pe, deg, mask)
    assert n_guard == 3 * with_pe + 7 * with_deg
    _, vjp = jax.vjp(lambda s: jmod.fused_modulated_attention(
        s, _j(mask), pe=_j(pe), degree=_j(deg)), _j(scores))
    (want,) = vjp(_j(g))
    ts = _t(scores).requires_grad_()
    tmod.fused_modulated_attention(ts, _t(mask), pe=_t(pe),
                                   degree=_t(deg)).backward(_t(g))
    np.testing.assert_allclose(ts.grad.numpy(), np.asarray(want), **GRAD_TOL)
    direct = tmod.modulation_bwd(_t(scores), _t(pe), _t(deg),
                                 _t(mask).float(), _t(g))
    assert torch.equal(direct, ts.grad)


def test_guard_rows_pass_the_cotangent_through():
    """Where |denom| <= 1e-9 the forward divides by the constant 1, so
    the backward is that of a * p * masks alone (du = g), which float64
    autograd of the plain forward gives; elsewhere the same holds with the
    renormalisation. In the guard rows with one pe entry of 1e-12 the
    gradient is ~1e-14, not 0 as du = 0 would make it."""
    scores, mask, pe, deg, g = _inputs(seed=2)
    pe[1, :3] = 0.0
    pe[1, :3, 5] = 1e-12            # |denom| tiny but nonzero: guard too
    s64 = _t(scores).double().requires_grad_()
    args = (_t(pe).double(), _t(deg).double(), _t(mask).double())
    tmod.modulation_fwd_plain(s64, *args).backward(_t(g).double())
    got = tmod.modulation_bwd_plain(_t(scores).double(), *args,
                                    _t(g).double())
    np.testing.assert_allclose(got.numpy(), s64.grad.numpy(), rtol=1e-10,
                               atol=1e-13)
    assert bool((got[1, :, :3] != 0).any())


def test_float64_scores_keep_float64_and_cpu_takes_no_kernel():
    scores, mask, pe, deg, g = _inputs(seed=3)
    before = tmod.modulation_fwd.launches, tmod.modulation_bwd.launches
    s = _t(scores).double().requires_grad_()
    attn = tmod.fused_modulated_attention(s, _t(mask), pe=_t(pe),
                                          degree=_t(deg))
    attn.backward(_t(g).double())
    assert attn.dtype == s.grad.dtype == torch.float64
    want = tmod.fused_modulated_attention(_t(scores), _t(mask), pe=_t(pe),
                                          degree=_t(deg))
    np.testing.assert_allclose(attn.detach().numpy(), want.numpy(),
                               **FWD_TOL)
    assert (tmod.modulation_fwd.launches,
            tmod.modulation_bwd.launches) == before
    with pytest.raises(ValueError, match="unsupported device"):
        tmod.modulation_fwd(torch.zeros(1, 1, 2, 2, device="meta"), None,
                            None, torch.ones(1, 2, device="meta"))
