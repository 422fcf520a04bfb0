"""The port's metrics, losses and graph tasks vs the JAX package, on the
CPU.

The metrics are numpy on both sides; they are held on inputs with tied
scores, NaN scores, unlabelled (NaN or < 0) entries and tasks with one
class only. The losses and `task_loss` run on tensors (the port) and jax
arrays (JAX) made from the same numpy inputs. Three `Trainer` steps of
the port are held to the JAX `Trainer` on the same two batches, both sides
on the "modulation" route (the JAX layers' Pallas kernels interpreted, as
tests/test_torch_zinc.py runs them), weights across with
`convert.from_flax`, dropout 0 and the sign flip off:
`DiffGraphTransformerGenGCNMolPcba` on `binary_graph` (16 tasks, 30 % of
the labels NaN) and `DiffGraphTransformerGenGCN` on `graph_clf`.

Tolerances:
  metrics                      rtol 1e-12 (float64, the same arithmetic);
  losses and task losses       rtol 1e-6 / atol 1e-7 (f32, log-softmax and
      log-sigmoid rounded by two libraries);
  Trainer steps                as tests/test_torch_zinc.py: losses and
      step-1 gradients rtol 1e-3 / atol 1e-5, parameters after 3 steps
      atol lr / 5 (entries whose gradient is zero up to rounding on both
      sides are held to that bound on the gradient instead).
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.experimental.pallas as pl
import jax.numpy as jnp

import feta_tmlr_tpu.config as jcfg
from feta_tmlr_tpu.data import batch as jbatch
from feta_tmlr_tpu.data.synthetic import zinc_like_dataset as j_zinc
from feta_tmlr_tpu.experiments.run_transformer_gengcn_molhiv import \
    ogb_like_dataset as j_ogb_like
from feta_tmlr_tpu.nn import models as jmodels
from feta_tmlr_tpu.nn import ogb as jogb
from feta_tmlr_tpu.pe import encodings as jpe
from feta_tmlr_tpu.train import losses as jlosses
from feta_tmlr_tpu.train import metrics as jmetrics
from feta_tmlr_tpu.train import trainer as jtrainer
from feta_tmlr_tpu_torch.convert import from_flax
from feta_tmlr_tpu_torch.data import batch as tbatch
from feta_tmlr_tpu_torch.data.synthetic import ogb_like_dataset as t_ogb_like
from feta_tmlr_tpu_torch.data.synthetic import zinc_like_dataset as t_zinc
from feta_tmlr_tpu_torch.nn import models as tmodels
from feta_tmlr_tpu_torch.nn import ogb as togb
from feta_tmlr_tpu_torch.pe import encodings as tpe
from feta_tmlr_tpu_torch.train import losses as tlosses
from feta_tmlr_tpu_torch.train import metrics as tmetrics
from feta_tmlr_tpu_torch.train import trainer as ttrainer

METRIC_TOL = dict(rtol=1e-12, atol=0)
LOSS_TOL = dict(rtol=1e-6, atol=1e-7)
LR = 1e-3
GRAD_TOL = dict(rtol=1e-3, atol=1e-5)
N_MAX = 24


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


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _scores(seed, n=60, tasks=None):
    """Scores with ties (rounded to 1 decimal) and a few NaN, binary
    labels with unlabelled entries (NaN; -1 where `tasks` is None)."""
    rng = np.random.default_rng(seed)
    shape = (n,) if tasks is None else (n, tasks)
    s = np.round(rng.standard_normal(shape), 1)
    s[rng.random(shape) < 0.05] = np.nan
    y = rng.integers(0, 2, shape).astype(np.float64)
    if tasks is None:
        y[rng.random(shape) < 0.1] = -1
    else:
        y[rng.random(shape) < 0.3] = np.nan
        y[:, 0] = 1                       # a task with one class only
    return s, y


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_metrics_match_jax(seed):
    s, y = _scores(seed)
    for name in ("roc_auc", "average_precision"):
        got = getattr(tmetrics, name)(s, y)
        want = getattr(jmetrics, name)(s, y)
        assert np.isfinite(got)
        np.testing.assert_allclose(got, want, **METRIC_TOL)
    # a single class, or no positive: NaN on both sides
    assert np.isnan(tmetrics.roc_auc(s, np.zeros_like(y)))
    assert np.isnan(tmetrics.average_precision(s, np.zeros_like(y)))
    st, yt = _scores(seed + 10, tasks=6)
    for fn in ("roc_auc", "average_precision"):
        got = tmetrics.multitask_mean(getattr(tmetrics, fn), st, yt)
        want = jmetrics.multitask_mean(getattr(jmetrics, fn), st, yt)
        np.testing.assert_allclose(got, want, **METRIC_TOL)
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((40, 5))
    labels = rng.integers(0, 5, 40)
    assert tmetrics.accuracy_graph(logits, labels) == \
        jmetrics.accuracy_graph(logits, labels)
    pred, target = rng.random(50) < 0.4, rng.random(50) < 0.5
    assert tmetrics.binary_f1(pred, target) == jmetrics.binary_f1(pred,
                                                                   target)
    assert tmetrics.binary_f1([0, 0], [0, 0]) == 0.0


def test_rank_metrics_do_not_depend_on_the_order():
    """Midranks and collapsed thresholds: a permutation of tied scores
    leaves ROC-AUC and AP unchanged."""
    s, y = _scores(5)
    keep = ~np.isnan(s) & (y >= 0)
    perm = np.random.default_rng(6).permutation(int(keep.sum()))
    for fn in (tmetrics.roc_auc, tmetrics.average_precision):
        assert fn(s[keep], y[keep]) == fn(s[keep][perm], y[keep][perm])


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("squared", [True, False])
def test_losses_match_jax(weighted, squared):
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((12, 4)).astype(np.float32)
    labels = rng.integers(0, 4, 12)
    class_w = rng.random(4).astype(np.float32) if weighted else None
    sample_w = rng.random(12).astype(np.float32) if weighted else None
    got = tlosses.hinge_loss(torch.from_numpy(logits),
                             torch.from_numpy(labels), 4, weight=class_w,
                             squared=squared, margin=0.8)
    want = jlosses.hinge_loss(jnp.asarray(logits), jnp.asarray(labels), 4,
                              weight=class_w, squared=squared, margin=0.8)
    np.testing.assert_allclose(float(got), float(want), **LOSS_TOL)
    got = tlosses.cross_entropy(torch.from_numpy(logits),
                                torch.from_numpy(labels), 4,
                                weight=sample_w)
    want = jlosses.cross_entropy(jnp.asarray(logits), jnp.asarray(labels), 4,
                                 weight=sample_w)
    np.testing.assert_allclose(float(got), float(want), **LOSS_TOL)
    assert set(tlosses.LOSS) == set(jlosses.LOSS)


@pytest.mark.parametrize("task,shape", [
    ("graph_clf", (10, 3)), ("binary_graph", (10,)),
    ("binary_graph", (10, 1)), ("binary_graph", (10, 7))])
def test_task_loss_matches_jax(task, shape):
    """CE over one logit row per graph; the sigmoid BCE over the labelled
    entries (NaN labels unlabelled, one task with none labelled)."""
    rng = np.random.default_rng(4)
    logits = (3 * rng.standard_normal(shape)).astype(np.float32)
    if task == "graph_clf":
        y = rng.integers(0, shape[1], shape[0]).astype(np.int32)
    else:
        y = rng.integers(0, 2, shape[:1] if len(shape) == 1 or shape[1] == 1
                         else shape).astype(np.float32)
        y[rng.random(y.shape) < 0.3] = np.nan
        if y.ndim == 2:
            y[:, 2] = np.nan
    mask = np.ones((shape[0], 5), bool)
    jb = SimpleNamespace(y=jnp.asarray(y), graph_mask=None,
                         node_mask=jnp.asarray(mask))
    tb = SimpleNamespace(y=torch.from_numpy(y),
                         node_mask=torch.from_numpy(mask))
    want = jtrainer.task_loss(task, jnp.asarray(logits), jb)
    got = ttrainer.task_loss(task, torch.from_numpy(logits), tb)
    assert torch.isfinite(got)
    np.testing.assert_allclose(float(got), float(want), **LOSS_TOL)


@pytest.mark.parametrize("metric", ["ap", "rocauc"])
def test_task_metric_matches_jax(metric):
    s, y = _scores(7, tasks=5)
    s = np.nan_to_num(s)
    for task, logits, labels in (
            ("binary_graph", s, y), ("binary_graph", s[:, 1], y[:, 1]),
            ("graph_clf", s, np.argmax(np.nan_to_num(y), -1))):
        got = ttrainer.task_metric(task, logits, labels,
                                   binary_metric=metric)
        want = jtrainer.task_metric(task, logits, labels,
                                    binary_metric=metric)
        assert got.keys() == want.keys()
        for k in got:
            np.testing.assert_allclose(got[k], want[k], **METRIC_TOL)


def test_unknown_task_raises_and_modes():
    model = tmodels.DiffGraphTransformerGenGCN(
        in_size=3, nb_class=2, d_model=8, nb_heads=2, nb_layers=1,
        device="cpu")
    with pytest.raises(ValueError, match="unknown task"):
        ttrainer.Trainer(model, ttrainer.TrainConfig(task="node_reg"))
    modes = {t: ttrainer.Trainer(model, ttrainer.TrainConfig(task=t))._mode
             for t in ttrainer.TASKS}
    assert modes == {"node_clf": "max", "graph_reg": "min",
                     "graph_clf": "max", "binary_graph": "max"}
    assert ttrainer.TrainConfig().binary_metric == \
        jtrainer.TrainConfig().binary_metric == "ap"


# ------------------------------------------------------ three Trainer steps

def _trainer_parity(jmodel, make_port, jbs, tbs, cfg):
    """Three steps of both trainers from the same perturbed weights; the
    losses, the step-1 gradients and the parameters after each step."""
    jtr = jtrainer.Trainer(jmodel, jtrainer.TrainConfig(**cfg))
    state = jtr.init(jax.random.key(0), jbs[0])
    rng = np.random.default_rng(13)
    params = {"params": jax.tree.map(
        lambda p: p + 0.05 * rng.standard_normal(p.shape).astype(np.float32),
        _np(state.params["params"]))}
    state = state.replace(params=params,
                          opt_state=jtr.optimizer.init(params))
    to_port = lambda p, s: from_flax(
        {"params": _np(p["params"]), "batch_stats": _np(s or {})},
        make_port())
    port = to_port(state.params, state.batch_stats)
    trainer = ttrainer.Trainer(port, ttrainer.TrainConfig(**cfg))
    _, jgrads, _ = jtr._loss_and_grads(state.params, state.batch_stats,
                                       jbs[0], jax.random.key(1))
    for i, k in enumerate((0, 1, 0)):
        state, jloss = jtr._jit_step(state, jbs[k], jax.random.key(1))
        tloss = trainer.step(tbs[k])
        np.testing.assert_allclose(float(tloss), float(jloss), **GRAD_TOL)
        if i == 0:
            want = dict(to_port(jgrads, state.batch_stats).named_parameters())
            real = {}
            for name, p in port.named_parameters():
                w = want[name].detach().numpy()
                g = p.grad.numpy()
                np.testing.assert_allclose(g, w, err_msg=name, **GRAD_TOL)
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


@pytest.mark.parametrize("jax_route", ["modulation"], indirect=True)
def test_trainer_binary_graph_molpcba_matches_jax(jax_route):
    """DiffGraphTransformerGenGCNMolPcba, 16 tasks, 30 % NaN labels."""
    cfg_m = dict(nb_class=16, d_model=32, nb_heads=4, dim_feedforward=64,
                 dropout=0.0, nb_layers=2, filter_order=2)
    keep = [i for i, g in enumerate(t_ogb_like(8, 20, 16))
            if g.num_nodes <= N_MAX][:4]
    jg = [j_ogb_like(8, 20, 16)[i] for i in keep]
    tg = [t_ogb_like(8, 20, 16)[i] for i in keep]
    rng = np.random.default_rng(9)
    for a, b in zip(jg, tg):
        a.y[rng.random(16) < 0.3] = np.nan
        b.y = a.y.copy()
    jbs = [jbatch.collate_graphs(jg[i:i + 2], max_nodes=N_MAX)
           for i in (0, 2)]
    tbs = [tbatch.collate_graphs(tg[i:i + 2], max_nodes=N_MAX)
           for i in (0, 2)]
    assert bool(torch.isnan(tbs[0].y).any())
    _trainer_parity(
        jogb.DiffGraphTransformerGenGCNMolPcba(**cfg_m),
        lambda: togb.DiffGraphTransformerGenGCNMolPcba(
            **cfg_m, attention_impl=jax_route, device="cpu"),
        jbs, tbs, dict(task="binary_graph", lr=LR, weight_decay=1e-5,
                       regularization=0.1, sign_flip=False))


@pytest.mark.parametrize("jax_route", ["modulation"], indirect=True)
def test_trainer_graph_clf_matches_jax(jax_route):
    """DiffGraphTransformerGenGCN on graph_clf: 3 classes, batch norm,
    LapPE, diffusion PE."""
    cfg_m = dict(in_size=28, nb_class=3, d_model=16, nb_heads=2,
                 dim_feedforward=32, dropout=0.0, nb_layers=2,
                 batch_norm=True, lap_pos_enc=True, lap_pos_enc_dim=4,
                 filter_order=3)
    keep = [i for i, g in enumerate(t_zinc(seed=5, n_graphs=40))
            if g.num_nodes <= N_MAX][:4]
    jg = [j_zinc(seed=5, n_graphs=40)[i] for i in keep]
    tg = [t_zinc(seed=5, n_graphs=40)[i] for i in keep]
    for i, (a, b) in enumerate(zip(jg, tg)):
        a.y = b.y = np.int32(i % 3)
    for enc in (jpe.DiffusionEncoding(beta=1.0), jpe.LapEncoding(4)):
        enc.apply_to(jg)
    for enc in (tpe.DiffusionEncoding(beta=1.0), tpe.LapEncoding(4)):
        enc.apply_to(tg)
    jbs = [jbatch.collate_graphs(jg[i:i + 2], max_nodes=N_MAX)
           for i in (0, 2)]
    tbs = [tbatch.collate_graphs(tg[i:i + 2], max_nodes=N_MAX)
           for i in (0, 2)]
    _trainer_parity(
        jmodels.DiffGraphTransformerGenGCN(**cfg_m),
        lambda: tmodels.DiffGraphTransformerGenGCN(
            **cfg_m, attention_impl=jax_route, device="cpu"),
        jbs, tbs, dict(task="graph_clf", lr=LR, weight_decay=1e-5,
                       regularization=0.1, sign_flip=False))
