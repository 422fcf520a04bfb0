"""The port's Trainer, optimizer, schedules and metrics vs the JAX package,
on the CPU.

Both trainers start from the same weights (`convert.from_flax`) and take
the same three AdamW steps on the same SBM batches, with dropout 0 and the
sign flip off, so no random numbers enter. The JAX model runs its flash
path with the Pallas kernels interpreted, so its backward goes through the
TPU backward kernels `_bwd_q_kernel` / `_bwd_k_kernel`; the port's runs the
plain versions of the CUDA backward kernels (CPU tensors).

Tolerances (f32, sums in other orders on the two sides):
  losses and step-1 gradients   rtol 1e-3 / atol 1e-5 (two attention
      layers, the coefficient head and the Chebyshev filter, forward and
      backward);
  parameters after 3 steps      atol 2e-4 = lr / 5. Adam moves a parameter
      by about lr * sign(g) whatever |g|, so where the gradient is zero
      up to rounding the two sides step by +-lr at random. Such entries
      (|g| < 1e-6 on both sides at step 1: the key bias, which enters only
      through the softmax-invariant row term cq, and the biases that a
      following batch norm cancels) are held to that bound on the
      gradient instead, and copied from the JAX state after each step so
      that their noise does not reach the next forward (a batch norm's
      running mean would absorb it); every other entry moves by the same
      update;
  batch-norm running statistics rtol 1e-4 / atol 1e-5.

At the full serving width (10 layers, d_model 64, 8 heads) the first
step's loss is held across JAX, the port in float32 and the port in float64
at rtol 1e-5; after that, from random weights, rounding parts the
trajectories, and the test holds only what every route shows
(`test_full_width_losses_jax_port_float64`).
"""

import copy
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.experimental.pallas as pl
import jax.numpy as jnp
import optax

import feta_tmlr_tpu.config as jcfg
from feta_tmlr_tpu.data import batch as jbatch
from feta_tmlr_tpu.data.synthetic import sbm_like_dataset as j_sbm
from feta_tmlr_tpu.nn import models as jmodels
from feta_tmlr_tpu.ops.pallas import flash_attention as jfl
from feta_tmlr_tpu.pe import encodings as jpe
from feta_tmlr_tpu.train import metrics as jmetrics
from feta_tmlr_tpu.train import optim as joptim
from feta_tmlr_tpu.train.trainer import TrainConfig as JTrainConfig
from feta_tmlr_tpu.train.trainer import Trainer as JTrainer
from feta_tmlr_tpu_torch.convert import from_flax
from feta_tmlr_tpu_torch.data import batch as tbatch
from feta_tmlr_tpu_torch.data.synthetic import sbm_like_dataset as t_sbm
from feta_tmlr_tpu_torch.nn import models as tmodels
from feta_tmlr_tpu_torch.pe import encodings as tpe
from feta_tmlr_tpu_torch.train import metrics as tmetrics
from feta_tmlr_tpu_torch.train import optim as toptim
from feta_tmlr_tpu_torch.train.trainer import TrainConfig, Trainer

FULL = dict(in_size=3, nb_class=2, d_model=64, nb_heads=8, dim_feedforward=128,
            dropout=0.0, nb_layers=10, batch_norm=True, lap_pos_enc=True,
            lap_pos_enc_dim=8, filter_order=4)
CFG = dict(in_size=3, nb_class=2, d_model=16, nb_heads=2, dim_feedforward=32,
           dropout=0.0, nb_layers=2, batch_norm=True, lap_pos_enc=True,
           lap_pos_enc_dim=4, filter_order=3)
N_MAX = 32
LR = 1e-3
GRAD_TOL = dict(rtol=1e-3, atol=1e-5)
PARAM_ATOL = LR / 5
STATS_TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture
def jax_flash_path(monkeypatch):
    orig = pl.pallas_call
    monkeypatch.setattr(jfl.pl, "pallas_call",
                        lambda *a, **k: orig(*a, interpret=True, **k))
    monkeypatch.setenv("FETA_PALLAS", "1")
    monkeypatch.setattr(jcfg, "_on_accelerator", lambda: True)
    monkeypatch.setattr(jcfg, "PALLAS_AUTO_N", 0)


def _batches(seed=8, per=2, n=N_MAX, lap_dim=4):
    """Two batches of `per` SBM graphs each, JAX and port collations."""
    jg = j_sbm(seed=seed, n_graphs=2 * per, n_nodes=n)
    tg = t_sbm(seed=seed, n_graphs=2 * per, n_nodes=n)
    for enc in (jpe.DiffusionEncoding(beta=1.0), jpe.LapEncoding(lap_dim)):
        enc.apply_to(jg)
    for enc in (tpe.DiffusionEncoding(beta=1.0), tpe.LapEncoding(lap_dim)):
        enc.apply_to(tg)
    kw = dict(max_nodes=n, node_labels=True)
    return ([jbatch.collate_graphs(jg[i:i + per], **kw) for i in (0, per)],
            [tbatch.collate_graphs(tg[i:i + per], **kw) for i in (0, per)])


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _port_from(params, batch_stats, cfg=CFG):
    model = tmodels.DiffGraphTransformerGenGCNSBM(**cfg, device="cpu")
    return from_flax({"params": _np(params), "batch_stats": _np(batch_stats)},
                     model)


def test_trainer_three_steps_match_jax(jax_flash_path):
    jbs, tbs = _batches()
    jcfg_ = JTrainConfig(task="node_clf", lr=LR, weight_decay=1e-5,
                         regularization=0.1, sign_flip=False)
    jtr = JTrainer(jmodels.DiffGraphTransformerGenGCNSBM(**CFG), jcfg_)
    state = jtr.init(jax.random.key(0), jbs[0])
    rng = np.random.default_rng(13)
    params = jax.tree.map(        # non-zero biases everywhere
        lambda p: p + 0.05 * rng.standard_normal(p.shape).astype(np.float32),
        state.params)
    state = state.replace(params=params,
                          opt_state=jtr.optimizer.init(params))

    port = _port_from(params["params"], state.batch_stats)
    trainer = Trainer(port, TrainConfig(lr=LR, weight_decay=1e-5,
                                        regularization=0.1, sign_flip=False))
    _, jgrads, _ = jtr._loss_and_grads(state.params, state.batch_stats,
                                       jbs[0], jax.random.key(1))
    order = (0, 1, 0)
    for i, k in enumerate(order):
        state, jloss = jtr._jit_step(state, jbs[k], jax.random.key(1))
        tloss = trainer.step(tbs[k])
        np.testing.assert_allclose(float(tloss), float(jloss), **GRAD_TOL)
        if i == 0:                      # step-1 gradients, by name
            want = dict(_port_from(jgrads["params"],
                                   state.batch_stats).named_parameters())
            real = {}
            for name, p in port.named_parameters():
                w = want[name].detach().numpy()
                np.testing.assert_allclose(p.grad.numpy(), w, err_msg=name,
                                           **GRAD_TOL)
                noise = (np.abs(w) < 1e-6) & (p.grad.abs().numpy() < 1e-6)
                real[name] = ~noise
            assert sum(int((~r).sum()) for r in real.values()) < 200
        want = _port_from(state.params["params"], state.batch_stats)
        with torch.no_grad():
            for name, p in want.named_parameters():
                noise = torch.from_numpy(~real[name])
                port.get_parameter(name)[noise] = p[noise]

    got_p = dict(port.named_parameters())
    for name, p in want.named_parameters():
        keep = real[name]
        np.testing.assert_allclose(got_p[name].detach().numpy()[keep],
                                   p.detach().numpy()[keep], rtol=0,
                                   atol=PARAM_ATOL, err_msg=name)
    got_b = dict(port.named_buffers())
    for name, b in want.named_buffers():
        np.testing.assert_allclose(got_b[name].numpy(), b.numpy(),
                                   err_msg=name, **STATS_TOL)


def _float64(batch):
    return dataclasses.replace(batch, **{
        f.name: getattr(batch, f.name).double()
        for f in dataclasses.fields(batch)
        if torch.is_tensor(getattr(batch, f.name))
        and getattr(batch, f.name).is_floating_point()})


@pytest.mark.parametrize("schedule", ["constant", "warmup"])
def test_full_width_losses_jax_port_float64(schedule):
    """Three epochs of the two batches at the full serving width (N=64,
    4 graphs a batch; the JAX model on its dense path) from one set of
    random weights, through the JAX trainer, the port in float32 and the
    port in float64, at lr 1e-3 constant or warmed up linearly over the 6
    steps. Prints the per-step losses (`pytest -s`).

    Step 1 agrees at rtol 1e-5 on all three. From step 3 on the routes
    part by percents, the port's own float32 and float64 runs as much as
    JAX and the port: the 10-layer model from random weights amplifies
    rounding. What holds on every route: at the constant lr the mean loss
    of epoch 3 lies above that of epoch 1, JAX's reference trainer
    included; with the warmup it lies below."""
    jbs, tbs = _batches(seed=2, per=4, n=64, lap_dim=8)
    extra = {"schedule": "warmup", "warmup_steps": 6} if \
        schedule == "warmup" else {}
    jtr = JTrainer(jmodels.DiffGraphTransformerGenGCNSBM(**FULL),
                   JTrainConfig(task="node_clf", lr=LR, weight_decay=1e-5,
                                sign_flip=False, **extra))
    state = jtr.init(jax.random.key(0), jbs[0])
    port = _port_from(state.params["params"], state.batch_stats, FULL)
    cfg = TrainConfig(lr=LR, weight_decay=1e-5, sign_flip=False, **extra)
    routes = {"port f32": (Trainer(port, cfg), tbs),
              "port f64": (Trainer(copy.deepcopy(port).double(), cfg),
                           [_float64(b) for b in tbs])}
    losses = {"jax": [], "port f32": [], "port f64": []}
    for _ in range(3):
        for k in (0, 1):
            state, jloss = jtr._jit_step(state, jbs[k], jax.random.key(1))
            losses["jax"].append(float(jloss))
            for name, (tr, bs) in routes.items():
                losses[name].append(float(tr.step(bs[k])))
    epochs = {k: np.mean(np.reshape(v, (3, 2)), 1) for k, v in losses.items()}
    for k in losses:
        print(f"{schedule} lr {LR}: {k} step losses "
              f"{np.round(losses[k], 6).tolist()}, epoch means "
              f"{np.round(epochs[k], 6).tolist()}")
    assert all(np.isfinite(v).all() for v in losses.values())
    for k in ("jax", "port f32"):
        assert losses[k][0] == pytest.approx(losses["port f64"][0], rel=1e-5)
    falls = [bool(e[2] < e[0]) for e in epochs.values()]
    assert falls == [schedule == "warmup"] * 3


def test_trainer_evaluate_and_fit_on_cpu():
    _, tbs = _batches()
    model = tmodels.DiffGraphTransformerGenGCNSBM(**CFG, device="cpu")
    trainer = Trainer(model, TrainConfig(lr=3e-3, epochs=3,
                                         schedule="plateau", seed=1))
    rows = []
    out = trainer.fit(tbs, val_batches=tbs[:1], test_batches=tbs[1:],
                      log_fn=rows.append)
    assert [r["epoch"] for r in rows] == [0, 1, 2]
    assert all(np.isfinite(r["loss"]) and "lr" in r for r in rows)
    assert trainer.steps == 6
    assert 0.0 <= out["best_val"] <= 1.0 and 0 <= out["best_epoch"] < 3
    assert out["best_val"] == rows[out["best_epoch"]]["val_acc_sbm"]
    # the model ends on its best-val weights
    assert trainer.evaluate(tbs[:1])["acc_sbm"] == out["best_val"]
    assert set(out["test"]) == {"acc_sbm"}


def test_sign_flip_is_reproducible_from_seed():
    _, tbs = _batches()
    model = tmodels.DiffGraphTransformerGenGCNSBM(**CFG, device="cpu")

    def flips(seed):
        tr = Trainer(model, TrainConfig(seed=seed))
        return [tr._sign_flip(tbs[0]).lap_pe / tbs[0].lap_pe.where(
            tbs[0].lap_pe != 0, torch.ones(())) for _ in range(4)]

    a, b, c = flips(5), flips(5), flips(6)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not all(torch.equal(x, y) for x, y in zip(a, c))
    signs = torch.stack([x[0, 0] for x in a])   # one sign per PE dimension
    assert set(signs.unique().tolist()) <= {-1.0, 1.0}
    assert not all(torch.equal(s, signs[0]) for s in signs)
    off = Trainer(model, TrainConfig(sign_flip=False))
    assert off._sign_flip(tbs[0]) is tbs[0]


def test_unported_tasks_raise():
    model = tmodels.DiffGraphTransformerGenGCNSBM(**CFG, device="cpu")
    for task in ("graph_clf", "graph_reg", "binary_graph"):
        with pytest.raises(ValueError, match="Queue 1 item 2"):
            Trainer(model, TrainConfig(task=task))
    with pytest.raises(ValueError, match="schedule"):
        Trainer(model, TrainConfig(schedule="cosine"))


@pytest.mark.parametrize("with_mask", [False, True])
def test_accuracy_sbm_matches_jax(with_mask):
    rng = np.random.default_rng(14)
    logits = rng.standard_normal((3, 20, 4)).astype(np.float32)
    labels = rng.integers(-1, 3, (3, 20))         # class 3 only predicted
    mask = rng.random((3, 20)) > 0.2 if with_mask else None
    assert tmetrics.accuracy_sbm(logits, labels, mask) == \
        jmetrics.accuracy_sbm(logits, labels, mask)


@pytest.mark.parametrize("clip", [None, 0.05])
def test_adamw_matches_optax(clip):
    rng = np.random.default_rng(15)
    p0 = rng.standard_normal((5, 3)).astype(np.float32)
    grads = [rng.standard_normal((5, 3)).astype(np.float32) for _ in range(4)]
    opt = joptim.make_optimizer(2e-2, weight_decay=0.1, grad_clip_norm=clip)
    jp, state = jnp.asarray(p0), opt.init(jnp.asarray(p0))
    tp = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    topt = toptim.make_optimizer([tp], 2e-2, weight_decay=0.1,
                                 grad_clip_norm=clip)
    for g in grads:
        upd, state = opt.update(jnp.asarray(g), state, jp)
        jp = optax.apply_updates(jp, upd)
        tp.grad = torch.from_numpy(g.copy())
        topt.step()
        # clip_grad_norm_ divides by norm + 1e-6 where optax divides by
        # the norm: a relative 1e-6 on the clipped gradient
        np.testing.assert_allclose(tp.detach().numpy(), np.asarray(jp),
                                   rtol=1e-5, atol=1e-6)


def test_schedules_match_jax():
    jstep = joptim.step_lr(1e-3, 3, 0.5, steps_per_epoch=4)
    tstep = toptim.step_lr(1e-3, 3, 0.5, steps_per_epoch=4)
    jwarm = joptim.warmup_inverse_sqrt(1e-3, 10)
    twarm = toptim.warmup_inverse_sqrt(1e-3, 10)
    for count in range(0, 40, 3):
        assert tstep(count) == pytest.approx(float(jstep(count)), rel=1e-12)
        assert twarm(count) == pytest.approx(
            float(jwarm(jnp.asarray(count))), rel=1e-6)
    metrics = [0.5, 0.6, 0.6, 0.59, 0.6, 0.61, 0.7, 0.7, 0.7, 0.7]
    for mode in ("max", "min"):
        jp = joptim.PlateauScheduler(patience=1, mode=mode, min_lr=1e-5)
        tp = toptim.PlateauScheduler(patience=1, mode=mode, min_lr=1e-5)
        assert [tp.step(m, 1e-3) for m in metrics] == \
            [jp.step(m, 1e-3) for m in metrics]
