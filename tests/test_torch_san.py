"""The port's SAN_NodeSpectra slice vs the JAX package, on the CPU.

Data (ZINC-shaped graphs, Laplacian eigen-PE, collation) must be exactly
equal. Modules and the model start from the same weights
(`convert.from_flax`, with non-zero biases and non-trivial batch-norm
statistics) and see the same numpy inputs. The port's FreqTransformer FFN
runs the plain version of the fused-MLP kernels (CPU tensors); the JAX one
runs either its dense chain (FETA_FUSED_MLP=0) or the Pallas fused-MLP
kernels in interpret mode (FETA_FUSED_MLP=1).

Tolerances (f32, sums in other orders on the two sides): modules rtol 1e-4
/ atol 1e-5; the two-layer model's logits and the Predictor rtol 5e-4 /
atol 5e-5 (attention, eigen-PE head, coefficient head, Chebyshev filter and
batch norm in a chain); training as in tests/test_torch_train.py: losses
and step-1 gradients rtol 1e-3 / atol 1e-5, parameters after 3 steps atol
lr / 5 (entries whose gradient is below 1e-6 on both sides, and not exactly
zero on both, are held on the gradient and copied across), batch-norm statistics rtol 1e-4 / atol 1e-5.
"""

import numpy as np
import pytest
import torch

import jax
import jax.experimental.pallas as pl
import jax.numpy as jnp

from feta_tmlr_tpu.data import batch as jbatch
from feta_tmlr_tpu.data.synthetic import zinc_categorical_dataset as j_zinc
from feta_tmlr_tpu.nn import san as jsan
from feta_tmlr_tpu.ops import cheb as jcheb
from feta_tmlr_tpu.ops.pallas import fused_mlp as jfm
from feta_tmlr_tpu.pe.laplace import apply_laplace_decomp as j_eig
from feta_tmlr_tpu.serve import Predictor as JPredictor
from feta_tmlr_tpu.train import metrics as jmetrics
from feta_tmlr_tpu.train.trainer import TrainConfig as JTrainConfig
from feta_tmlr_tpu.train.trainer import Trainer as JTrainer
from feta_tmlr_tpu_torch.convert import from_flax
from feta_tmlr_tpu_torch.data import batch as tbatch
from feta_tmlr_tpu_torch.data.synthetic import zinc_categorical_dataset as t_zinc
from feta_tmlr_tpu_torch.nn import san as tsan
from feta_tmlr_tpu_torch.ops import cheb as tcheb
from feta_tmlr_tpu_torch.pe.laplace import apply_laplace_decomp as t_eig
from feta_tmlr_tpu_torch.serve import Predictor as TPredictor
from feta_tmlr_tpu_torch.train import metrics as tmetrics
from feta_tmlr_tpu_torch.train.trainer import TrainConfig, Trainer

TOL = dict(rtol=1e-4, atol=1e-5)
MODEL_TOL = dict(rtol=5e-4, atol=5e-5)
GRAD_TOL = dict(rtol=1e-3, atol=1e-5)
STATS_TOL = dict(rtol=1e-4, atol=1e-5)
LR = 1e-3
N_MAX = 32
M_FREQS = 10
CFG = dict(num_atom_type=28, num_bond_type=4, hidden_dim=16, out_dim=16,
           n_heads=2, n_layers=2, lpe_dim=4, lpe_heads=2, lpe_layers=2,
           filter_order=3)


@pytest.fixture
def fused_interpret(monkeypatch):
    """The JAX FreqTransformer on its Pallas fused-MLP route (interpret)."""
    orig = pl.pallas_call
    monkeypatch.setattr(jfm.pl, "pallas_call",
                        lambda *a, **k: orig(*a, interpret=True, **k))
    monkeypatch.setenv("FETA_FUSED_MLP", "1")


@pytest.fixture
def no_freq_dropout(monkeypatch):
    """The JAX FreqTransformer with dropout 0 (same parameter tree), so a
    training step draws no random numbers on the JAX side."""
    class FreqTransformerNoDropout(jsan.FreqTransformer):
        dropout: float = 0.0

    monkeypatch.setattr(jsan, "FreqTransformer", FreqTransformerNoDropout)


def _graphs(seed=1, n_graphs=4):
    jg, tg = j_zinc(seed=seed, n_graphs=n_graphs), \
        t_zinc(seed=seed, n_graphs=n_graphs)
    j_eig(jg, M_FREQS)
    t_eig(tg, M_FREQS)
    return jg, tg


def _batches(seed=1, n_graphs=4):
    jg, tg = _graphs(seed, n_graphs)
    return (jbatch.collate_graphs(jg, max_nodes=N_MAX),
            tbatch.collate_graphs(tg, max_nodes=N_MAX))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _perturb(variables, seed=11):
    """Non-zero biases everywhere and batch-norm statistics far from
    (0, 1), as a trained model has."""
    rng = np.random.default_rng(seed)
    out = {"params": jax.tree.map(
        lambda p: np.asarray(p) + 0.05 * rng.standard_normal(
            p.shape).astype(np.float32), variables["params"])}
    if "batch_stats" in variables:
        out["batch_stats"] = jax.tree_util.tree_map_with_path(
            lambda path, a: (rng.random(a.shape) + 0.5 if path[-1].key ==
                             "var" else 0.3 * rng.standard_normal(a.shape)
                             ).astype(np.float32),
            _np(variables["batch_stats"]))
    return out


def _f(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


# ------------------------------------------------------------------ data

def test_zinc_dataset_and_eigen_pe_identical():
    jg, tg = _graphs(n_graphs=6)
    assert any(g.num_nodes < M_FREQS for g in tg)   # NaN-padded frequencies
    for a, b in zip(jg, tg):
        for f in ("x", "edge_index", "edge_type", "y", "degree", "eigvecs",
                  "eigvals"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                          err_msg=f)


def test_collate_zinc_identical():
    jb, tb = _batches()
    for f in ("x", "node_mask", "adj", "y", "edge_type", "eigvecs",
              "eigvals"):
        want, got = np.asarray(getattr(jb, f)), getattr(tb, f)
        assert got.dtype == torch.from_numpy(want).dtype, f
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f)
    assert tb.x.shape == (4, N_MAX) and tb.y.shape == (4,)
    moved = tb.to("cpu")
    assert torch.equal(moved.edge_type, tb.edge_type)
    assert torch.isnan(moved.eigvals).any()


# --------------------------------------------------------------- modules

def test_structure_laplacian_and_typed_scores_match_jax():
    jb, tb = _batches()
    want = jsan.san_structure_laplacian(jnp.asarray(jb.adj),
                                        jnp.asarray(jb.node_mask))
    got = tsan.san_structure_laplacian(tb.adj, tb.node_mask)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    q, k, table = _f(4, 2, N_MAX, 3, seed=1), _f(4, 2, N_MAX, 3, seed=2), \
        _f(4, 2, 3, seed=3)
    want = jsan.typed_edge_scores(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(table), jnp.asarray(jb.edge_type),
                                  0.5)
    got = tsan.typed_edge_scores(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(table), tb.edge_type, 0.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("gamma", [1e-5, 0.1])
def test_san_attention_matches_jax(gamma):
    jb, tb = _batches()
    h = _f(4, N_MAX, 12) * np.asarray(jb.node_mask)[..., None]
    table = _f(4, 10, seed=5)
    jmod = jsan.SANAttention(out_dim=3, num_heads=2, gamma=gamma)
    ekw = dict(e_table=jnp.asarray(table),
               edge_ids=jnp.asarray(jb.edge_type))
    args = (jnp.asarray(h), None, jnp.asarray(jb.adj),
            jnp.asarray(jb.node_mask))
    variables = _perturb(jmod.init(jax.random.key(0), *args, **ekw))
    want = jmod.apply(variables, *args, **ekw)
    port = from_flax(variables, tsan.SANAttention(12, 3, 2, gamma=gamma,
                                                  edge_dim=10))
    got = port(torch.from_numpy(h), tb.adj, tb.node_mask,
               torch.from_numpy(table), tb.edge_type)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), **TOL)


def test_coeff_head_and_scalar_cheb_filter_match_jax():
    jb, tb = _batches()
    mask = np.asarray(jb.node_mask)
    attn = np.abs(_f(4, 2, N_MAX, N_MAX, seed=6)) * mask[:, None, None, :]
    jmod = jsan.SANCoeffHead(filter_order=3)
    variables = _perturb(jmod.init(jax.random.key(0), jnp.asarray(attn),
                                   jnp.asarray(mask)))
    want = jmod.apply(variables, jnp.asarray(attn), jnp.asarray(mask))
    port = from_flax(variables, tsan.SANCoeffHead(3))
    coeff = port(torch.from_numpy(attn), tb.node_mask)
    np.testing.assert_allclose(coeff.detach().numpy(), np.asarray(want),
                               **TOL)

    x, w, bias = _f(4, 2, N_MAX, 5, seed=7), _f(3, 5, 4, seed=8), \
        _f(4, seed=9)
    lhat = np.asarray(jsan.san_structure_laplacian(jnp.asarray(jb.adj),
                                                   jnp.asarray(mask)))
    c = np.asarray(want)
    want = jcheb.cheb_filter_scalar_coeff(*(jnp.asarray(a) for a in
                                            (x, lhat, c, w, bias)))
    got = tcheb.cheb_filter_scalar_coeff(*(torch.tensor(a) for a in
                                           (x, lhat, c, w, bias)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("fused", ["0", "1"])
def test_freq_and_lpe_transformer_match_jax(fused, monkeypatch):
    """FETA_FUSED_MLP=1: the JAX FFN through the Pallas fused-MLP kernel in
    interpret mode; =0: its dense chain. Eval mode, so no dropout."""
    if fused == "1":
        orig = pl.pallas_call
        monkeypatch.setattr(jfm.pl, "pallas_call",
                            lambda *a, **k: orig(*a, interpret=True, **k))
    monkeypatch.setenv("FETA_FUSED_MLP", fused)
    tokens = _f(24, 10, 2, seed=10)
    fmask = np.random.default_rng(11).random((24, 10)) > 0.2
    jmod = jsan.FreqTransformer(lpe_dim=8, lpe_heads=4, lpe_layers=2,
                                ff_dim=128)
    variables = _perturb(jmod.init(jax.random.key(0), jnp.asarray(tokens),
                                   jnp.asarray(fmask)))
    want = jmod.apply(variables, jnp.asarray(tokens), jnp.asarray(fmask))
    port = from_flax(variables, tsan.FreqTransformer(2, 8, 4, 2, ff_dim=128))
    got = port.eval()(torch.from_numpy(tokens), torch.from_numpy(fmask))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)

    jb, tb = _batches()
    jlpe = jsan.LPETransformer(lpe_dim=4, lpe_heads=2, lpe_layers=2)
    args = (jnp.asarray(jb.eigvecs), jnp.asarray(jb.eigvals),
            jnp.asarray(jb.node_mask))
    variables = _perturb(jlpe.init(jax.random.key(1), *args))
    want = jlpe.apply(variables, *args)
    port = from_flax(variables, tsan.LPETransformer(4, 2, 2)).eval()
    got = port(tb.eigvecs, tb.eigvals, tb.node_mask)
    assert np.isfinite(got.detach().numpy()).all()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("train", [False, True])
def test_spectra_layer_matches_jax(train):
    """Eval: batch norm on its running statistics; train: on the masked
    batch statistics, and the updated running statistics agree too."""
    jb, tb = _batches()
    mask = np.asarray(jb.node_mask)
    h = _f(4, N_MAX, 16, seed=12) * mask[..., None]
    table = _f(4, 16, seed=13)
    jmod = jsan.SANSpectraLayer(out_dim=16, num_heads=2, filter_order=3)
    args = (jnp.asarray(h), None, jnp.asarray(jb.adj), jnp.asarray(mask))
    ekw = dict(e_table=jnp.asarray(table),
               edge_ids=jnp.asarray(jb.edge_type))
    variables = _perturb(jmod.init(jax.random.key(0), *args, **ekw))
    if train:
        want, updated = jmod.apply(variables, *args, False, **ekw,
                                   mutable=["batch_stats"])
    else:
        want = jmod.apply(variables, *args, True, **ekw)
    port = from_flax(variables, tsan.SANSpectraLayer(16, 16, 2,
                                                     filter_order=3))
    port.train(train)
    got = port(torch.from_numpy(h), tb.adj, tb.node_mask,
               e_table=torch.from_numpy(table), edge_ids=tb.edge_type)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    if train:
        stats = from_flax({**variables, "batch_stats": _np(
            updated["batch_stats"])}, tsan.SANSpectraLayer(
                16, 16, 2, filter_order=3))
        for (name, b), (_, w) in zip(port.named_buffers(),
                                     stats.named_buffers()):
            np.testing.assert_allclose(b.numpy(), w.numpy(), err_msg=name,
                                       **STATS_TOL)


# ----------------------------------------------------------------- model

def _jax_model(jb):
    model = jsan.SANNodeSpectra(**CFG)
    return model, _perturb(model.init(jax.random.key(0), jb))


def _port_model(variables):
    return from_flax(_np(variables),
                     tsan.SANNodeSpectra(**CFG, device="cpu"))


@pytest.mark.parametrize("fused", ["0", "1"])
def test_san_node_spectra_logits_match_jax(fused, monkeypatch):
    if fused == "1":
        orig = pl.pallas_call
        monkeypatch.setattr(jfm.pl, "pallas_call",
                            lambda *a, **k: orig(*a, interpret=True, **k))
    monkeypatch.setenv("FETA_FUSED_MLP", fused)
    jb, tb = _batches()
    jmodel, variables = _jax_model(jb)
    want = jmodel.apply(variables, jb)
    port = _port_model(variables).eval()
    with torch.inference_mode():
        got = port(tb)
    assert got.shape == (4, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODEL_TOL)


def test_predictor_serves_san_like_jax():
    jg, tg = _graphs(seed=7, n_graphs=5)
    jb = jbatch.collate_graphs(jg[:2], max_nodes=N_MAX)
    jmodel, variables = _jax_model(jb)
    kw = dict(max_batch=2, collate_kwargs={"max_nodes": N_MAX})
    want = JPredictor(jmodel, variables=variables, **kw).predict(jg)
    got = TPredictor(_port_model(variables), device="cpu", **kw).predict(tg)
    assert got.shape == (5, 1)                    # chunks of 2, 2, 1
    np.testing.assert_allclose(got, np.asarray(want), **MODEL_TOL)


def test_model_dropout_is_seeded_and_train_only():
    _, tb = _batches()
    model = tsan.SANNodeSpectra(**CFG, seed=3, device="cpu").train()
    runs = []
    for seed in (5, 5, 6):
        model.dropout_generator.manual_seed(seed)
        runs.append(model(tb).detach())
    assert torch.equal(runs[0], runs[1])
    assert not torch.equal(runs[0], runs[2])
    model.eval()
    assert torch.equal(model(tb), model(tb))
    off = tsan.SANNodeSpectra(**CFG, seed=3, device="cpu").train()
    off.pe_transformer.freq_transformer.dropout = 0.0
    off.dropout_generator.manual_seed(5)
    state = off.dropout_generator.get_state()
    off(tb)
    assert torch.equal(off.dropout_generator.get_state(), state)


# -------------------------------------------------------------- training

def test_trainer_graph_reg_three_steps_match_jax(no_freq_dropout,
                                                 fused_interpret):
    """Three AdamW steps of the port's Trainer against the JAX Trainer on
    the same two batches: sign flip off, FreqTransformer dropout 0 on both
    sides (the JAX FreqTransformer swapped for a subclass), the JAX FFN
    through the interpreted Pallas fused-MLP kernels and their backward."""
    jg, tg = _graphs(seed=4, n_graphs=4)
    jbs = [jbatch.collate_graphs(jg[i:i + 2], max_nodes=N_MAX)
           for i in (0, 2)]
    tbs = [tbatch.collate_graphs(tg[i:i + 2], max_nodes=N_MAX)
           for i in (0, 2)]
    jcfg = JTrainConfig(task="graph_reg", lr=LR, weight_decay=1e-5,
                        regularization=0.1, sign_flip=False)
    jtr = JTrainer(jsan.SANNodeSpectra(**CFG), jcfg)
    state = jtr.init(jax.random.key(0), jbs[0])
    params = _perturb({"params": state.params["params"]})
    state = state.replace(params=params, opt_state=jtr.optimizer.init(params))
    to_port = lambda p, s: _port_model({"params": p["params"],
                                        "batch_stats": s})
    port = to_port(state.params, state.batch_stats)
    port.pe_transformer.freq_transformer.dropout = 0.0
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
                g = p.grad.numpy()
                tiny = (np.abs(w) < 1e-6) & (np.abs(g) < 1e-6)
                real[name] = ~(tiny & ~((w == 0) & (g == 0)))
            # mostly the fake-edge projections Q_2/K_2/E_2, whose scores
            # enter scaled by gamma = 1e-5, and biases a batch norm cancels;
            # exact zeros on both sides (dead ReLU units, absent atom
            # types) take no Adam step and stay checked
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


def test_trainer_graph_reg_fit_selects_lowest_mae():
    jg, tg = _graphs(seed=6, n_graphs=6)
    tbs = [tbatch.collate_graphs(tg[i:i + 3], max_nodes=N_MAX)
           for i in (0, 3)]
    model = tsan.SANNodeSpectra(**CFG, device="cpu")
    trainer = Trainer(model, TrainConfig(task="graph_reg", lr=3e-3,
                                         epochs=3, schedule="plateau",
                                         regularization=0.1, seed=1))
    assert trainer.plateau.mode == "min"
    rows = []
    out = trainer.fit(tbs, val_batches=tbs[:1], log_fn=rows.append)
    maes = [r["val_mae"] for r in rows]
    assert out["best_val"] == min(maes)
    assert out["best_epoch"] == int(np.argmin(maes))
    assert trainer.evaluate(tbs[:1])["mae"] == pytest.approx(out["best_val"],
                                                             rel=1e-6)


def test_eigvec_sign_flip_is_separate_and_seeded():
    _, tb = _batches()
    tb.lap_pe = torch.ones(4, N_MAX, 3)
    model = tsan.SANNodeSpectra(**CFG, device="cpu")

    def flips(seed):
        tr = Trainer(model, TrainConfig(task="graph_reg", seed=seed))
        out = []
        for _ in range(4):
            b = tr._sign_flip(tb)
            out.append((b.lap_pe[0, 0], (b.eigvecs / tb.eigvecs)[0, 0]))
        return out

    a, b = flips(5), flips(5)
    assert all(torch.equal(x[0], y[0]) and torch.equal(x[1], y[1])
               for x, y in zip(a, b))
    signs = torch.cat([torch.cat(x) for x in a])
    assert set(signs.unique().tolist()) <= {-1.0, 1.0}
    # the eigvec signs are their own draw, not the lap-PE signs repeated
    assert not all(torch.equal(x[0], x[1][:3]) for x in a)
    flipped = Trainer(model, TrainConfig(task="graph_reg"))._sign_flip(tb)
    assert torch.equal(torch.isnan(flipped.eigvecs), torch.isnan(tb.eigvecs))


def test_mae_matches_jax():
    rng = np.random.default_rng(14)
    pred, y = rng.standard_normal(9), rng.standard_normal(9)
    assert tmetrics.mae(pred, y) == jmetrics.mae(pred, y)
