"""The flagship ZINC model (`DiffGraphTransformerGenGCN`) of the port vs the
JAX package, on the CPU, under each attention route.

The route is the port's `attention_impl` and, on the JAX side, the
environment switches it mirrors: FETA_PALLAS=1 and FETA_PALLAS_IMPL=flash,
modulation or fused, with the Pallas kernels in interpret mode and the
accelerator check forced true (as `tests/test_torch_layers.py` does for
the flash route). Under "modulation" every layer runs the TPU modulation
kernels (#8/#9); under "fused" the unfiltered layers run the single-block
fused kernels (#10/#11) and the filtered layer the modulation kernels. The
port's layers run the kernels' plain versions on CPU tensors. Weights go
across with `convert.from_flax`; inputs come from `zinc_like_dataset` with
the same seed on both sides, cut to graphs of at most N_MAX nodes.

Tolerances (f32, sums in other orders on the two sides):
  one layer                     rtol 2e-4 / atol 2e-5, as
      tests/test_torch_layers.py (attention, FFN and two norms);
  layer gradients               rtol 1e-3 / atol 1e-5, as there;
  model forward                 rtol 5e-4 / atol 5e-5, as
      tests/test_torch_model.py (two layers, the coefficient head and the
      Chebyshev filter);
  Trainer steps                 as tests/test_torch_train.py: losses and
      step-1 gradients rtol 1e-3 / atol 1e-5, parameters after 3 steps
      atol lr / 5 (entries whose gradient is zero up to rounding on both
      sides are held to that bound on the gradient instead), batch-norm
      statistics rtol 1e-4 / atol 1e-5.
"""

import numpy as np
import pytest
import torch

import jax
import jax.experimental.pallas as pl
import jax.numpy as jnp

import feta_tmlr_tpu.config as jcfg
from feta_tmlr_tpu.data import batch as jbatch
from feta_tmlr_tpu.data.synthetic import zinc_like_dataset as j_zinc
from feta_tmlr_tpu.nn import layers as jlayers
from feta_tmlr_tpu.nn import models as jmodels
from feta_tmlr_tpu.pe import encodings as jpe
from feta_tmlr_tpu.train.trainer import TrainConfig as JTrainConfig
from feta_tmlr_tpu.train.trainer import Trainer as JTrainer
from feta_tmlr_tpu_torch.convert import from_flax
from feta_tmlr_tpu_torch.data import batch as tbatch
from feta_tmlr_tpu_torch.data.synthetic import zinc_like_dataset as t_zinc
from feta_tmlr_tpu_torch.nn import layers as tlayers
from feta_tmlr_tpu_torch.nn import models as tmodels
from feta_tmlr_tpu_torch.pe import encodings as tpe
from feta_tmlr_tpu_torch.serve import Predictor as TPredictor
from feta_tmlr_tpu_torch.train.trainer import TrainConfig, Trainer

CFG = dict(in_size=28, nb_class=1, d_model=16, nb_heads=2, dim_feedforward=32,
           dropout=0.0, nb_layers=2, batch_norm=True, lap_pos_enc=True,
           lap_pos_enc_dim=4, filter_order=3)
N_MAX = 24
IMPLS = ("flash", "modulation", "fused")
LAYER_TOL = dict(rtol=2e-4, atol=2e-5)
LAYER_GRAD_TOL = dict(rtol=1e-3, atol=1e-5)
MODEL_TOL = dict(rtol=5e-4, atol=5e-5)
LR = 1e-3
GRAD_TOL = dict(rtol=1e-3, atol=1e-5)
STATS_TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture
def jax_route(monkeypatch, request):
    """The JAX layers on the Pallas route `request.param`, interpreted."""
    orig = pl.pallas_call
    monkeypatch.setattr(pl, "pallas_call",
                        lambda *a, **k: orig(*a, interpret=True, **k))
    monkeypatch.setenv("FETA_PALLAS", "1")
    monkeypatch.setenv("FETA_PALLAS_IMPL", request.param)
    monkeypatch.setattr(jcfg, "_on_accelerator", lambda: True)
    return request.param


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _graphs(seed=0, n_graphs=4, lap_dim=4):
    """The first `n_graphs` graphs of at most N_MAX nodes, both sides."""
    keep = [i for i, g in enumerate(t_zinc(seed=seed, n_graphs=40))
            if g.num_nodes <= N_MAX][:n_graphs]
    jg = [j_zinc(seed=seed, n_graphs=40)[i] for i in keep]
    tg = [t_zinc(seed=seed, n_graphs=40)[i] for i in keep]
    for enc in (jpe.DiffusionEncoding(beta=1.0), jpe.LapEncoding(lap_dim)):
        enc.apply_to(jg)
    for enc in (tpe.DiffusionEncoding(beta=1.0), tpe.LapEncoding(lap_dim)):
        enc.apply_to(tg)
    return jg, tg


def _perturb(variables, rng):
    """Non-zero biases everywhere and non-trivial running statistics."""
    out = dict(variables)
    out["params"] = jax.tree.map(
        lambda p: p + 0.05 * rng.standard_normal(p.shape).astype(np.float32),
        variables["params"])
    if "batch_stats" in variables:
        out["batch_stats"] = jax.tree_util.tree_map_with_path(
            lambda path, a: (rng.random(a.shape) + 0.5
                             if path[-1].key == "var"
                             else 0.3 * rng.standard_normal(a.shape)
                             ).astype(np.float32),
            _np(variables["batch_stats"]))
    return out


def test_zinc_like_dataset_identical():
    for jg, tg in zip(j_zinc(seed=3, n_graphs=20), t_zinc(seed=3, n_graphs=20)):
        for field in ("x", "edge_index", "y", "degree"):
            np.testing.assert_array_equal(getattr(tg, field),
                                          getattr(jg, field))
    sizes = [g.num_nodes for g in t_zinc(seed=0, n_graphs=128)]
    assert 9 <= min(sizes) and max(sizes) <= 37


def _layer_inputs(seed, b=3, n=N_MAX, d=16):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, n, d)).astype(np.float32)
    mask = np.ones((b, n), bool)
    mask[0, n - 5:] = False
    mask[2, n - 11:] = False
    pe = (rng.random((b, n, n)) * mask[:, :, None]
          * mask[:, None, :]).astype(np.float32)
    deg = (rng.random((b, n)) * mask).astype(np.float32)
    return x, mask, pe, deg


@pytest.mark.parametrize("need_heads", [False, True])
@pytest.mark.parametrize("jax_route", IMPLS, indirect=True)
def test_graphit_layer_route_matches_jax(jax_route, need_heads):
    x, mask, pe, deg = _layer_inputs(seed=7)
    layer = jlayers.GraphiTEncoderLayer(16, 2, 32, 0.0, True)
    jargs = tuple(jnp.asarray(a) for a in (x, pe, mask, deg))
    variables = _perturb(dict(layer.init(jax.random.key(0), *jargs)),
                         np.random.default_rng(8))
    w_out, w_attn, w_heads = layer.apply(variables, *jargs,
                                         need_heads=need_heads)
    port = tlayers.GraphiTEncoderLayer(16, 2, 32, 0.0, True,
                                       attention_impl=jax_route).eval()
    from_flax(_np(variables), port)
    with torch.inference_mode():
        g_out, g_attn, g_heads = port(_t(x), _t(pe), _t(mask), _t(deg),
                                      need_heads=need_heads)
    np.testing.assert_allclose(g_out.numpy(), np.asarray(w_out), **LAYER_TOL)
    if need_heads:
        np.testing.assert_allclose(g_heads.numpy(), np.asarray(w_heads),
                                   **LAYER_TOL)
    else:
        assert g_heads is None and w_heads is None
    if w_attn is None:             # the kernel routes of need_heads=False
        assert g_attn is None
    elif need_heads and jax_route == "flash":
        np.testing.assert_allclose(g_attn.s.numpy(), np.asarray(w_attn.s),
                                   **LAYER_TOL)
    else:                          # the score route's dense attention
        assert g_attn.shape == (3, 2, N_MAX, N_MAX)
        np.testing.assert_allclose(g_attn.numpy(), np.asarray(w_attn),
                                   **LAYER_TOL)


@pytest.mark.parametrize("jax_route,need_heads", [
    ("modulation", True), ("fused", False)], indirect=["jax_route"])
def test_graphit_layer_route_grads_match_jax(jax_route, need_heads):
    """Train-mode gradients of one layer w.r.t. every parameter and the
    input, vs jax.grad of the JAX layer on the same route (the modulation
    or fused backward kernel, interpreted). The other two cases run the
    same backward kernels: ("fused", True) is the modulation route's
    filtered layer, and ("modulation", False) differs from it only by the
    plain vw contraction; the flash route's layer gradients are
    tests/test_torch_layers.py's."""
    x, mask, pe, deg = _layer_inputs(seed=16)
    rng = np.random.default_rng(17)
    layer = jlayers.GraphiTEncoderLayer(16, 2, 32, 0.0, True)
    jx, jpe_, jmask, jdeg = (jnp.asarray(a) for a in (x, pe, mask, deg))
    variables = dict(layer.init(jax.random.key(0), jx, jpe_, jmask, jdeg))
    variables["params"] = _perturb(variables, rng)["params"]
    g_out = rng.standard_normal(x.shape).astype(np.float32)
    g_heads = rng.standard_normal((3, N_MAX, 2, 8)).astype(np.float32)

    def jloss(params, xin):
        (out, _, heads), _ = layer.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            xin, jpe_, jmask, jdeg, deterministic=False,
            need_heads=need_heads, mutable=["batch_stats"])
        loss = (out * g_out).sum()
        return loss + (heads * g_heads).sum() if need_heads else loss

    w_params, w_x = jax.grad(jloss, argnums=(0, 1))(variables["params"], jx)
    make = lambda: tlayers.GraphiTEncoderLayer(16, 2, 32, 0.0, True,
                                               attention_impl=jax_route)
    port = from_flax(_np(variables), make()).train()
    tx = _t(x).requires_grad_()
    out, _, heads = port(tx, _t(pe), _t(mask), _t(deg), need_heads=need_heads)
    loss = (out * _t(g_out)).sum()
    if need_heads:
        loss = loss + (heads * _t(g_heads)).sum()
    loss.backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(w_x),
                               **LAYER_GRAD_TOL)
    want = dict(from_flax({"params": _np(w_params),
                           "batch_stats": _np(variables["batch_stats"])},
                          make()).named_parameters())
    for name, p in port.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(),
                                   want[name].detach().numpy(),
                                   err_msg=name, **LAYER_GRAD_TOL)


def _jax_model(jb):
    model = jmodels.DiffGraphTransformerGenGCN(**CFG)
    variables = _perturb(dict(model.init(jax.random.key(0), jb)),
                         np.random.default_rng(11))
    return model, variables


def _port_model(variables, impl):
    model = tmodels.DiffGraphTransformerGenGCN(**CFG, attention_impl=impl,
                                               device="cpu")
    return from_flax(_np(variables), model)


@pytest.mark.parametrize("jax_route", IMPLS, indirect=True)
def test_zinc_model_matches_jax(jax_route):
    """The whole model's forward (logits [B, 1] and regularizer), and the
    graph-level Predictor serving the same graphs."""
    jg, tg = _graphs(n_graphs=3)
    jb = jbatch.collate_graphs(jg, max_nodes=N_MAX)
    jmodel, variables = _jax_model(jb)
    want, want_reg = jmodel.apply(variables, jb, regularization=0.1)
    port = _port_model(variables, jax_route).eval()
    tb = tbatch.collate_graphs(tg, max_nodes=N_MAX)
    with torch.inference_mode():
        got, got_reg = port(tb, regularization=0.1)
    assert got.shape == (3, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODEL_TOL)
    np.testing.assert_allclose(float(got_reg), float(want_reg), **MODEL_TOL)
    served = TPredictor(port, device="cpu", max_batch=2,
                        collate_kwargs={"max_nodes": N_MAX}).predict(tg)
    np.testing.assert_allclose(served, np.asarray(want), **MODEL_TOL)


@pytest.mark.parametrize("jax_route", ["modulation", "fused"], indirect=True)
def test_trainer_graph_reg_three_steps_match_jax(jax_route):
    """Three AdamW steps (L1 loss, coefficient regularizer 0.1, sign flip
    off) of the port's Trainer against the JAX Trainer on the same two
    batches, both sides on the same route. The flash route's Trainer
    parity is tests/test_torch_train.py's (the same layers and Trainer;
    this model adds only the mean pool, held on every route by
    `test_zinc_model_matches_jax`)."""
    jg, tg = _graphs(seed=5, n_graphs=4)
    jbs = [jbatch.collate_graphs(jg[i:i + 2], max_nodes=N_MAX)
           for i in (0, 2)]
    tbs = [tbatch.collate_graphs(tg[i:i + 2], max_nodes=N_MAX)
           for i in (0, 2)]
    jtr = JTrainer(jmodels.DiffGraphTransformerGenGCN(**CFG),
                   JTrainConfig(task="graph_reg", lr=LR, weight_decay=1e-5,
                                regularization=0.1, sign_flip=False))
    state = jtr.init(jax.random.key(0), jbs[0])
    params = _perturb({"params": state.params["params"]},
                      np.random.default_rng(13))
    state = state.replace(params=params,
                          opt_state=jtr.optimizer.init(params))
    to_port = lambda p, s: _port_model(
        {"params": p["params"], "batch_stats": s}, jax_route)
    port = to_port(state.params, state.batch_stats)
    trainer = Trainer(port, TrainConfig(task="graph_reg", lr=LR,
                                        weight_decay=1e-5,
                                        regularization=0.1, sign_flip=False))
    _, jgrads, _ = jtr._loss_and_grads(state.params, state.batch_stats,
                                       jbs[0], jax.random.key(1))
    for i, k in enumerate((0, 1, 0)):
        state, jloss = jtr._jit_step(state, jbs[k], jax.random.key(1))
        tloss = trainer.step(tbs[k])
        np.testing.assert_allclose(float(tloss), float(jloss), **GRAD_TOL)
        if i == 0:                      # step-1 gradients, by name
            want = dict(to_port(jgrads, state.batch_stats).named_parameters())
            real = {}
            for name, p in port.named_parameters():
                w = want[name].detach().numpy()
                np.testing.assert_allclose(p.grad.numpy(), w, err_msg=name,
                                           **GRAD_TOL)
                # the key bias (softmax-invariant) and biases a batch norm
                # cancels: zero up to rounding, Adam steps them by +-lr;
                # exact zeros on both sides (embedding rows of atom types
                # absent from the batch) take no step and stay checked
                g = p.grad.numpy()
                tiny = (np.abs(w) < 1e-6) & (np.abs(g) < 1e-6)
                real[name] = ~(tiny & ~((w == 0) & (g == 0)))
            n_params = sum(p.numel() for p in port.parameters())
            assert sum(int((~r).sum()) for r in real.values()) < \
                0.05 * n_params
        want = to_port(state.params, state.batch_stats)
        with torch.no_grad():
            for name, p in want.named_parameters():
                noise = torch.from_numpy(~real[name])
                port.get_parameter(name)[noise] = p[noise]
    got_p = dict(port.named_parameters())
    for name, p in want.named_parameters():
        keep = real[name]
        np.testing.assert_allclose(got_p[name].detach().numpy()[keep],
                                   p.detach().numpy()[keep], rtol=0,
                                   atol=LR / 5, err_msg=name)
    got_b = dict(port.named_buffers())
    for name, b in want.named_buffers():
        np.testing.assert_allclose(got_b[name].numpy(), b.numpy(),
                                   err_msg=name, **STATS_TOL)


def test_unknown_route_raises():
    with pytest.raises(ValueError, match="attention_impl"):
        tmodels.DiffGraphTransformerGenGCN(**CFG, attention_impl="xla",
                                           device="cpu")
