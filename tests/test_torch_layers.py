"""Port layers and graph ops vs the JAX package, on the CPU.

Inputs are made by numpy from a seed and fed to both sides. The JAX
GraphiT layer is forced onto its flash path (the Pallas kernels in
interpret mode, as tests/test_flash_need_heads.py runs them), which is the
path it takes at the slice's N >= 1024 on the chip; the port's layer runs
the kernels' plain versions on CPU tensors.

Tolerances (f32): graph ops rtol 1e-5 / atol 1e-6 (same arithmetic,
different summation order); the attention layer rtol 2e-4 / atol 2e-5
(online-softmax rescaling and the FFN/norm chain round differently), as
the JAX package's own streamed-vs-dense layer test.
"""

import numpy as np
import pytest
import torch

import jax
import jax.experimental.pallas as pl
import jax.numpy as jnp

import feta_tmlr_tpu.config as jcfg
from feta_tmlr_tpu.nn import feta as jfeta
from feta_tmlr_tpu.nn import layers as jlayers
from feta_tmlr_tpu.ops import attention as jattn
from feta_tmlr_tpu.ops import cheb as jcheb
from feta_tmlr_tpu.ops import laplacian as jlap
from feta_tmlr_tpu.ops import masking as jmask
from feta_tmlr_tpu.ops.pallas import flash_attention as jfl
from feta_tmlr_tpu_torch.convert import from_flax
from feta_tmlr_tpu_torch.nn import feta as tfeta
from feta_tmlr_tpu_torch.nn import layers as tlayers
from feta_tmlr_tpu_torch.ops import attention as tattn
from feta_tmlr_tpu_torch.ops import cheb as tcheb
from feta_tmlr_tpu_torch.ops import laplacian as tlap
from feta_tmlr_tpu_torch.ops import masking as tmask

OPS_TOL = dict(rtol=1e-5, atol=1e-6)
LAYER_TOL = dict(rtol=2e-4, atol=2e-5)


@pytest.fixture
def jax_flash_path(monkeypatch):
    """Route the JAX layer through its flash kernels, interpreted."""
    orig = pl.pallas_call
    monkeypatch.setattr(jfl.pl, "pallas_call",
                        lambda *a, **k: orig(*a, interpret=True, **k))
    monkeypatch.setenv("FETA_PALLAS", "1")
    monkeypatch.setattr(jcfg, "_on_accelerator", lambda: True)
    monkeypatch.setattr(jcfg, "PALLAS_AUTO_N", 0)


def _t(a):
    return torch.from_numpy(np.array(a))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _graph_inputs(seed=0, b=2, n=12, pad=3):
    rng = np.random.default_rng(seed)
    mask = np.ones((b, n), bool)
    mask[0, n - pad:] = False
    adj = (rng.random((b, n, n)) < 0.3).astype(np.float32)
    adj = np.maximum(adj, adj.transpose(0, 2, 1))
    adj[1, 0, 0] = 1.0                     # a self loop must be dropped
    adj[1, 3, :] = adj[1, :, 3] = 0.0      # an isolated real node
    return adj * mask[:, :, None] * mask[:, None, :], mask


@pytest.mark.parametrize("norm,lam", [("sym", None), ("rw", 1.7),
                                      (None, np.array([3.0, 5.0]))])
def test_cheb_scaled_laplacian_matches_jax(norm, lam):
    adj, mask = _graph_inputs(seed=1)
    want = jlap.cheb_scaled_laplacian(
        jnp.asarray(adj), jnp.asarray(mask), normalization=norm,
        lambda_max=None if lam is None else jnp.asarray(lam, jnp.float32))
    got = tlap.cheb_scaled_laplacian(
        _t(adj), _t(mask), normalization=norm,
        lambda_max=None if lam is None else _t(np.float32(lam)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **OPS_TOL)


def test_gcn_norm_directed_and_masking_match_jax():
    rng = np.random.default_rng(2)
    _, mask = _graph_inputs(seed=2)
    a = rng.random((2, 3, 12, 12)).astype(np.float32)
    a[:, :, np.arange(4), np.arange(4)] = 0.0     # missing self loops
    mh = mask[:, None, :]
    for fill in (1.0, 2.0):
        want = jlap.gcn_norm_directed(jnp.asarray(a), jnp.asarray(mh), fill)
        got = tlap.gcn_norm_directed(_t(a), _t(mh), fill)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **OPS_TOL)
    np.testing.assert_array_equal(tmask.pair_mask(_t(mask)).numpy(),
                                  np.asarray(jmask.pair_mask(mask)))
    x = rng.standard_normal((2, 12, 5)).astype(np.float32)
    np.testing.assert_allclose(
        tmask.masked_mean(_t(x), _t(mask), dim=1).numpy(),
        np.asarray(jmask.masked_mean(jnp.asarray(x), mask, axis=1)),
        **OPS_TOL)


@pytest.mark.parametrize("k_order", [1, 2, 4])
def test_cheb_filter_dynamic_matches_jax(k_order):
    rng = np.random.default_rng(3)
    adj, mask = _graph_inputs(seed=3)
    lhat = np.asarray(jlap.cheb_scaled_laplacian(jnp.asarray(adj),
                                                 jnp.asarray(mask)))
    x = rng.standard_normal((2, 3, 12, 4)).astype(np.float32)
    w = rng.standard_normal((2, 3, k_order, 4, 5)).astype(np.float32)
    bias = rng.standard_normal(5).astype(np.float32)
    want = jcheb.cheb_filter_dynamic(jnp.asarray(x), jnp.asarray(lhat),
                                     jnp.asarray(w), jnp.asarray(bias))
    got = tcheb.cheb_filter_dynamic(_t(x), _t(lhat), _t(w), _t(bias))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **OPS_TOL)


def test_modulated_attention_from_scores_matches_jax():
    rng = np.random.default_rng(4)
    _, mask = _graph_inputs(seed=4)
    s = rng.standard_normal((2, 3, 12, 12)).astype(np.float32)
    v = rng.standard_normal((2, 3, 12, 4)).astype(np.float32)
    pe = rng.random((2, 12, 12)).astype(np.float32)
    deg = rng.random((2, 12)).astype(np.float32)
    for kw in ({}, {"pe": pe, "degree": deg}):
        wo, wa = jattn.modulated_attention_from_scores(
            jnp.asarray(s), jnp.asarray(v), jnp.asarray(mask),
            **{k: jnp.asarray(a) for k, a in kw.items()})
        go, ga = tattn.modulated_attention_from_scores(
            _t(s), _t(v), _t(mask), **{k: _t(a) for k, a in kw.items()})
        np.testing.assert_allclose(ga.numpy(), np.asarray(wa), **OPS_TOL)
        np.testing.assert_allclose(go.numpy(), np.asarray(wo), **OPS_TOL)


@pytest.mark.parametrize("precomputed", [False, True])
def test_filter_coefficient_head_matches_jax(precomputed):
    rng = np.random.default_rng(5)
    _, mask = _graph_inputs(seed=5)
    attn = rng.random((2, 3, 12, 12)).astype(np.float32)
    s = rng.standard_normal((2, 3, 12)).astype(np.float32)
    head = jfeta.FilterCoefficientHead(6)
    args = ((None, jnp.asarray(mask), jnp.asarray(s)) if precomputed
            else (jnp.asarray(attn), jnp.asarray(mask)))
    variables = head.init(jax.random.key(0), *args)
    variables = {"params": jax.tree.map(
        lambda p: p + 0.1 * rng.standard_normal(p.shape).astype(np.float32),
        variables["params"])}              # non-zero biases too
    want = head.apply(variables, *args)
    port = from_flax(_np_tree(variables), tfeta.FilterCoefficientHead(6))
    targs = ((None, _t(mask), _t(s)) if precomputed
             else (_t(attn), _t(mask)))
    got = port(*targs)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **OPS_TOL)


def _layer_inputs(seed=7, b=2, n=32, d=16, pad=5):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, n, d)).astype(np.float32)
    mask = np.ones((b, n), bool)
    mask[0, n - pad:] = False
    pe = (rng.random((b, n, n)) * mask[:, :, None]
          * mask[:, None, :]).astype(np.float32)
    deg = (rng.random((b, n)) * mask).astype(np.float32)
    return x, mask, pe, deg


def _perturb_batch_stats(variables, rng):
    """Non-trivial running statistics (init gives mean 0, var 1)."""
    if "batch_stats" not in variables:
        return variables
    stats = jax.tree_util.tree_map_with_path(
        lambda path, a: (rng.random(a.shape) + 0.5 if path[-1].key == "var"
                         else rng.standard_normal(a.shape)).astype(np.float32),
        _np_tree(variables["batch_stats"]))
    return {**variables, "batch_stats": stats}


@pytest.mark.parametrize("batch_norm", [False, True])
@pytest.mark.parametrize("need_heads", [False, True])
def test_graphit_layer_matches_jax(need_heads, batch_norm, jax_flash_path):
    x, mask, pe, deg = _layer_inputs()
    layer = jlayers.GraphiTEncoderLayer(16, 2, 32, 0.0, batch_norm)
    jargs = (jnp.asarray(x), jnp.asarray(pe), jnp.asarray(mask),
             jnp.asarray(deg))
    variables = layer.init(jax.random.key(0), *jargs)
    rng = np.random.default_rng(8)
    variables = _perturb_batch_stats(dict(variables), rng)
    variables["params"] = jax.tree.map(       # non-zero biases
        lambda p: p + 0.05 * rng.standard_normal(p.shape).astype(np.float32),
        variables["params"])
    w_out, w_attn, w_heads = layer.apply(variables, *jargs,
                                         need_heads=need_heads)

    port = tlayers.GraphiTEncoderLayer(16, 2, 32, 0.0, batch_norm).eval()
    from_flax(_np_tree(variables), port)
    with torch.inference_mode():
        g_out, g_attn, g_heads = port(_t(x), _t(pe), _t(mask), _t(deg),
                                      need_heads=need_heads)
    np.testing.assert_allclose(g_out.numpy(), np.asarray(w_out), **LAYER_TOL)
    if need_heads:
        assert isinstance(w_attn, jlayers.AttnColStats)
        assert isinstance(g_attn, tlayers.AttnColStats)
        np.testing.assert_allclose(g_heads.numpy(), np.asarray(w_heads),
                                   **LAYER_TOL)
        np.testing.assert_allclose(g_attn.s.numpy(), np.asarray(w_attn.s),
                                   **LAYER_TOL)
    else:
        assert g_attn is None and g_heads is None


@pytest.mark.parametrize("need_heads", [False, True])
def test_graphit_layer_grads_match_jax(need_heads, jax_flash_path):
    """Train-mode gradients of one layer (batch norm on its batch
    statistics) w.r.t. every parameter and the input, vs jax.grad of the
    JAX layer on its flash path (backward kernels #3/#4 interpreted).
    Tolerance rtol 1e-3 / atol 1e-5: a backward through attention, FFN and
    two batch norms in f32, sums in other orders on the two sides."""
    x, mask, pe, deg = _layer_inputs(seed=16)
    rng = np.random.default_rng(17)
    layer = jlayers.GraphiTEncoderLayer(16, 2, 32, 0.0, True)
    jx, jpe_, jmask, jdeg = (jnp.asarray(a) for a in (x, pe, mask, deg))
    variables = dict(layer.init(jax.random.key(0), jx, jpe_, jmask, jdeg))
    variables["params"] = jax.tree.map(       # non-zero biases
        lambda p: p + 0.05 * rng.standard_normal(p.shape).astype(np.float32),
        variables["params"])
    g_out = rng.standard_normal(x.shape).astype(np.float32)
    g_heads = rng.standard_normal((2, 32, 2, 8)).astype(np.float32)

    def jloss(params, xin):
        (out, _, heads), _ = layer.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            xin, jpe_, jmask, jdeg, deterministic=False,
            need_heads=need_heads, mutable=["batch_stats"])
        loss = (out * g_out).sum()
        return loss + (heads * g_heads).sum() if need_heads else loss

    w_params, w_x = jax.grad(jloss, argnums=(0, 1))(variables["params"], jx)

    port = from_flax(_np_tree(variables),
                     tlayers.GraphiTEncoderLayer(16, 2, 32, 0.0, True))
    port.train()
    tx = _t(x).requires_grad_()
    out, _, heads = port(tx, _t(pe), _t(mask), _t(deg),
                         need_heads=need_heads)
    loss = (out * _t(g_out)).sum()
    if need_heads:
        loss = loss + (heads * _t(g_heads)).sum()
    loss.backward()
    tol = dict(rtol=1e-3, atol=1e-5)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(w_x), **tol)
    want = from_flax({"params": _np_tree(w_params),
                      "batch_stats": _np_tree(variables["batch_stats"])},
                     tlayers.GraphiTEncoderLayer(16, 2, 32, 0.0, True))
    want = dict(want.named_parameters())
    for name, p in port.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(),
                                   want[name].detach().numpy(),
                                   err_msg=name, **tol)


def test_r4_filtered_layer_blocked_products_match_jax_and_float64(
        jax_flash_path, monkeypatch):
    """The "r4" setting's filtered layer (flash_need_heads=False: the score
    route, its products over the nodes in blocks of NODE_BLOCK,
    `ops/cheb.py`) at N = 96 > NODE_BLOCK: outputs, per-head outputs and
    train-mode gradients w.r.t. every parameter and the input against the
    JAX layer on its score route (FETA_FLASH_NEED_HEADS=0, the modulation
    kernel interpreted), at rtol 2e-4 / atol 2e-5 forward and rtol 1e-3 /
    atol 1e-5 gradients as above; and the same float32 layer against
    itself in float64 within 1e-5 of each tensor's largest entry."""
    monkeypatch.setenv("FETA_FLASH_NEED_HEADS", "0")
    x, mask, pe, deg = _layer_inputs(seed=19, n=96, pad=7)
    rng = np.random.default_rng(20)
    layer = jlayers.GraphiTEncoderLayer(16, 2, 32, 0.0, True)
    jx, jpe_, jmask, jdeg = (jnp.asarray(a) for a in (x, pe, mask, deg))
    variables = dict(layer.init(jax.random.key(0), jx, jpe_, jmask, jdeg))
    variables["params"] = jax.tree.map(       # non-zero biases
        lambda p: p + 0.05 * rng.standard_normal(p.shape).astype(np.float32),
        variables["params"])
    g_out = rng.standard_normal(x.shape).astype(np.float32)
    g_heads = rng.standard_normal((2, 96, 2, 8)).astype(np.float32)

    def jforward(params, xin):
        (out, _, heads), _ = layer.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            xin, jpe_, jmask, jdeg, deterministic=False, need_heads=True,
            mutable=["batch_stats"])
        return out, heads

    def jloss(params, xin):
        out, heads = jforward(params, xin)
        return (out * g_out).sum() + (heads * g_heads).sum()

    w_out, w_heads = jforward(variables["params"], jx)
    w_params, w_x = jax.grad(jloss, argnums=(0, 1))(variables["params"], jx)

    def port_run(dtype):
        port = from_flax(_np_tree(variables), tlayers.GraphiTEncoderLayer(
            16, 2, 32, 0.0, True, flash_need_heads=False)).to(dtype)
        port.train()
        tx = _t(x).to(dtype).requires_grad_()
        out, _, heads = port(tx, *(_t(a).to(dtype) for a in (pe, mask, deg)),
                             need_heads=True)
        ((out * _t(g_out).to(dtype)).sum()
         + (heads * _t(g_heads).to(dtype)).sum()).backward()
        grads = {n: p.grad for n, p in port.named_parameters()}
        return out.detach(), heads.detach(), tx.grad, grads

    out, heads, dx, grads = port_run(torch.float32)
    np.testing.assert_allclose(out.numpy(), np.asarray(w_out), **LAYER_TOL)
    np.testing.assert_allclose(heads.numpy(), np.asarray(w_heads),
                               **LAYER_TOL)
    tol = dict(rtol=1e-3, atol=1e-5)
    np.testing.assert_allclose(dx.numpy(), np.asarray(w_x), **tol)
    want = from_flax({"params": _np_tree(w_params),
                      "batch_stats": _np_tree(variables["batch_stats"])},
                     tlayers.GraphiTEncoderLayer(16, 2, 32, 0.0, True))
    want = dict(want.named_parameters())
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[name].detach().numpy(),
                                   err_msg=name, **tol)
    ref = port_run(torch.float64)
    pairs = [("out", out, ref[0]), ("heads", heads, ref[1]),
             ("dx", dx, ref[2])] + [(n, grads[n], ref[3][n]) for n in grads]
    for name, got, w in pairs:
        # a bias that batch norm cancels has a gradient of 0 in exact
        # arithmetic, float32 rounding all there is of it: held to the
        # input gradient's scale
        scale = float(w.abs().max())
        if scale < 1e-9:
            scale = float(ref[2].abs().max())
        assert float((got.double() - w).abs().max()) <= 1e-5 * scale, name


def _grad_fn_names(t):
    seen, todo, names = set(), [t.grad_fn], set()
    while todo:
        fn = todo.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        names.add(type(fn).__name__)
        todo.extend(f for f, _ in fn.next_functions)
    return names


@pytest.mark.parametrize("need_heads", [False, True])
def test_layer_trains_through_flash_function_and_dropout(need_heads):
    x, mask, pe, deg = _layer_inputs(seed=18)
    args = (_t(x), _t(pe), _t(mask), _t(deg))
    layer = tlayers.GraphiTEncoderLayer(16, 2, 32, 0.5, True)
    torch.manual_seed(0)
    out, _, _ = layer.train()(*args, need_heads=need_heads)
    assert "FlashGraphiTBackward" in _grad_fn_names(out)
    with torch.no_grad():          # eval: no dropout; train: a new mask
        a = layer.eval()(*args, need_heads=need_heads)[0]
        b = layer(*args, need_heads=need_heads)[0]
        c = layer.train()(*args, need_heads=need_heads)[0]
        d = layer(*args, need_heads=need_heads)[0]
    assert torch.equal(a, b) and not torch.allclose(c, d)


def test_masked_batch_norm_train_mode_matches_jax():
    rng = np.random.default_rng(9)
    x, mask, _, _ = _layer_inputs(seed=9)
    bn = jlayers.MaskedBatchNorm()
    variables = bn.init(jax.random.key(0), jnp.asarray(x),
                        jnp.asarray(mask), use_running_average=False)
    variables = _perturb_batch_stats(dict(variables), rng)
    want, upd = bn.apply(variables, jnp.asarray(x), jnp.asarray(mask),
                         use_running_average=False, mutable=["batch_stats"])
    port = from_flax(_np_tree(variables), tlayers.MaskedBatchNorm(16))
    port.train()
    got = port(_t(x), _t(mask))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **OPS_TOL)
    for name in ("mean", "var"):
        np.testing.assert_allclose(
            getattr(port, name).numpy(),
            np.asarray(upd["batch_stats"][name]), **OPS_TOL)
    port.eval()          # eval: the (updated) running statistics
    want_eval = bn.apply({**variables, **upd}, jnp.asarray(x),
                         jnp.asarray(mask), use_running_average=True)
    np.testing.assert_allclose(port(_t(x), _t(mask)).detach().numpy(),
                               np.asarray(want_eval), **OPS_TOL)


def test_layer_rejects_indivisible_heads():
    with pytest.raises(ValueError, match="divide evenly"):
        tlayers.GraphiTEncoderLayer(10, 3)
