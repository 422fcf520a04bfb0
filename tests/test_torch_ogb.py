"""The port's OGB molecular models, atom encoder, synthetic molecules and
raw-CSV reader vs the JAX package, on the CPU.

Weights go across with `convert.from_flax`; inputs come from the same
seeds on both sides (`ogb_like_dataset`, the molhiv CLI's synthetic
fallback, and the OGB fixtures under tests/fixtures), cut to graphs of at
most N_MAX nodes. The JAX layers run the Pallas route under test in
interpret mode (FETA_PALLAS=1, FETA_PALLAS_IMPL, the accelerator check
forced true, as tests/test_torch_zinc.py does); the port's layers run the
kernels' plain versions on CPU tensors.

Tolerances (f32, sums in other orders on the two sides):
  atom encoder                 rtol 1e-6 / atol 1e-6 (nine embedding rows
      summed in the same order);
  model forward                rtol 5e-4 / atol 5e-5, as
      tests/test_torch_zinc.py (two layers, the coefficient head, the
      Chebyshev filter and the head);
  d_model 128 forward and      outputs rtol 5e-4 / atol 5e-5, parameter
      gradients                gradients rtol 1e-3 / atol 1e-5, as the
      layer gradients of tests/test_torch_layers.py;
  the reader                   exact: the same arrays, NaN in the same
      places.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.experimental.pallas as pl
import jax.numpy as jnp

import feta_tmlr_tpu.config as jcfg
from feta_tmlr_tpu.data import batch as jbatch
from feta_tmlr_tpu.data import ogb_raw as jogb_raw
from feta_tmlr_tpu.experiments.run_transformer_gengcn_molhiv import \
    ogb_like_dataset as j_ogb_like
from feta_tmlr_tpu.nn import ogb as jogb
from feta_tmlr_tpu.ops.pallas import flash_attention as jfl
from feta_tmlr_tpu_torch.convert import from_flax
from feta_tmlr_tpu_torch.data import batch as tbatch
from feta_tmlr_tpu_torch.data import ogb_raw as togb_raw
from feta_tmlr_tpu_torch.data.synthetic import ogb_like_dataset as t_ogb_like
from feta_tmlr_tpu_torch.nn import ogb as togb
from feta_tmlr_tpu_torch.ops.kernels import flash_attention as tfl
from feta_tmlr_tpu_torch.serve import Predictor as TPredictor

FIXTURES = str(__import__("pathlib").Path(__file__).parent / "fixtures")
N_MAX = 24
SMALL = dict(d_model=32, nb_heads=4, dim_feedforward=64, dropout=0.0,
             nb_layers=2, filter_order=2)
WIDE = dict(d_model=128, nb_heads=8, dim_feedforward=256, dropout=0.0,
            nb_layers=2, filter_order=4)
MODELS = {"molhiv": ("DiffGraphTransformerGenGCNMolHiv", 1),
          "molpcba": ("DiffGraphTransformerGenGCNMolPcba", 16),
          "pcqm4m": ("DiffGraphTransformerGenGCNPCQM4M", 1)}
ENC_TOL = dict(rtol=1e-6, atol=1e-6)
MODEL_TOL = dict(rtol=5e-4, atol=5e-5)
GRAD_TOL = dict(rtol=1e-3, atol=1e-5)


@pytest.fixture
def jax_route(monkeypatch, request):
    """The JAX layers on the Pallas route `request.param`, interpreted."""
    orig = pl.pallas_call
    monkeypatch.setattr(pl, "pallas_call",
                        lambda *a, **k: orig(*a, interpret=True, **k))
    monkeypatch.setattr(jfl.pl, "pallas_call",
                        lambda *a, **k: orig(*a, interpret=True, **k))
    monkeypatch.setenv("FETA_PALLAS", "1")
    monkeypatch.setenv("FETA_PALLAS_IMPL", request.param)
    monkeypatch.setattr(jcfg, "_on_accelerator", lambda: True)
    monkeypatch.setattr(jcfg, "PALLAS_AUTO_N", 0)
    return request.param


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


def _graphs(seed, n_graphs, n_tasks=1, task="molhiv"):
    """The first `n_graphs` molecules of at most N_MAX atoms of
    `ogb_like_dataset(seed)`, both sides' copies; molpcba's labels lose 30 %
    of their entries to NaN, pcqm4m's become a float target."""
    keep = [i for i, g in enumerate(t_ogb_like(seed, 40, n_tasks))
            if g.num_nodes <= N_MAX][:n_graphs]
    jg = [j_ogb_like(seed, 40, n_tasks)[i] for i in keep]
    tg = [t_ogb_like(seed, 40, n_tasks)[i] for i in keep]
    rng = np.random.default_rng(seed + 100)
    for a, b in zip(jg, tg):
        if task == "molpcba":
            y = a.y.copy()
            y[rng.random(n_tasks) < 0.3] = np.nan
            a.y, b.y = y, y.copy()
        elif task == "pcqm4m":
            a.y = b.y = np.float32(rng.standard_normal())
    return jg, tg


def _perturb(variables, rng):
    """Non-zero biases everywhere."""
    return {"params": jax.tree.map(
        lambda p: p + 0.05 * rng.standard_normal(p.shape).astype(np.float32),
        _np(variables["params"]))}


def test_ogb_like_dataset_identical():
    """Equal seeds give equal molecules on both sides."""
    for n_tasks in (1, 16):
        for jg, tg in zip(j_ogb_like(4, 30, n_tasks),
                          t_ogb_like(4, 30, n_tasks)):
            for field in ("x", "edge_index", "y", "degree"):
                np.testing.assert_array_equal(getattr(tg, field),
                                              getattr(jg, field))
    sizes = [g.num_nodes for g in t_ogb_like(0, 128)]
    assert 8 <= min(sizes) and max(sizes) <= 27
    assert togb.ATOM_FEATURE_DIMS == jogb.ATOM_FEATURE_DIMS
    assert togb.BOND_FEATURE_DIMS == jogb.BOND_FEATURE_DIMS


def test_atom_encoder_matches_jax():
    """The sum of nine embeddings, and NaN where an id lies outside its
    column's vocabulary (jnp.take's fill), negative ids from the end."""
    rng = np.random.default_rng(3)
    x = np.stack([rng.integers(0, d, (2, 7)) for d in jogb.ATOM_FEATURE_DIMS],
                 axis=-1).astype(np.int32)
    x[0, 3, 2] = 12                 # one past column 2's vocabulary
    x[1, 5, 7] = -2                 # the first row, counted from the end
    x[1, 6, 8] = -3                 # outside
    enc = jogb.OGBAtomEncoder(emb_dim=16)
    variables = enc.init(jax.random.key(0), jnp.asarray(x))
    want = np.asarray(enc.apply(variables, jnp.asarray(x)))
    port = from_flax(_np(variables), togb.OGBAtomEncoder(16))
    with torch.no_grad():
        got = port(_t(x)).numpy()
    assert np.isnan(want).any(axis=-1).tolist() == np.isnan(got).any(
        axis=-1).tolist() and np.isnan(got[0, 3]).all()
    np.testing.assert_allclose(got, want, equal_nan=True, **ENC_TOL)


def _jax_model(name, nb_class, cfg, jb, seed=0):
    model = getattr(jogb, MODELS[name][0])(nb_class=nb_class, **cfg)
    variables = _perturb(model.init(jax.random.key(seed), jb),
                         np.random.default_rng(seed + 11))
    return model, variables


def _port_model(name, nb_class, cfg, variables, impl):
    model = getattr(togb, MODELS[name][0])(nb_class=nb_class, **cfg,
                                           attention_impl=impl, device="cpu")
    return from_flax(_np(variables), model)


@pytest.mark.parametrize("name", list(MODELS))
@pytest.mark.parametrize("jax_route", ["flash", "modulation"],
                         indirect=True)
def test_ogb_model_matches_jax(jax_route, name):
    """Each OGB model's forward (outputs and the "max" regularizer) at
    d_model 32, and the graph-level Predictor serving the same graphs,
    its [B] or [B, T] outputs stacked as the JAX Predictor stacks them."""
    nb_class = MODELS[name][1]
    jg, tg = _graphs(5, 4, nb_class, name)
    jb = jbatch.collate_graphs(jg, max_nodes=N_MAX)
    jmodel, variables = _jax_model(name, nb_class, SMALL, jb)
    want = jmodel.apply(variables, jb, regularization=0.1)
    port = _port_model(name, nb_class, SMALL, variables, jax_route).eval()
    with torch.inference_mode():
        got = port(tbatch.collate_graphs(tg, max_nodes=N_MAX),
                   regularization=0.1)
    assert len(got) == len(want)
    shape = (4,) if nb_class == 1 else (4, nb_class)
    assert got[0].shape == shape
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **MODEL_TOL)
    served = TPredictor(port, device="cpu", max_batch=3,
                        collate_kwargs={"max_nodes": N_MAX}).predict(tg)
    assert served.shape == shape
    np.testing.assert_allclose(served, np.asarray(want[0]), **MODEL_TOL)


@pytest.mark.parametrize("jax_route", ["flash"], indirect=True)
def test_molhiv_d128_flash_matches_jax_with_gradients(jax_route,
                                                      monkeypatch):
    """The molhiv model at its CLI width (d_model 128, 8 heads; two
    layers, the first unfiltered, dv 128, the second filtered, dv 16) on
    the flash route: the port's plain route against the JAX layers'
    interpreted Pallas flash kernels, outputs and every parameter's
    gradient of sum(logits * w) + 0.1 reg. Spies show that both sides
    went through the flash route at D = 128."""
    jg, tg = _graphs(6, 3)
    jb = jbatch.collate_graphs(jg, max_nodes=N_MAX)
    jmodel, variables = _jax_model("molhiv", 1, WIDE, jb, seed=2)
    w = np.random.default_rng(7).standard_normal(3).astype(np.float32)

    jcalls = []
    j_fwd = jfl._call_fwd
    monkeypatch.setattr(jfl, "_call_fwd", lambda *a, **k: (
        jcalls.append(a[0].shape), j_fwd(*a, **k))[1])

    def jloss(params):
        logits, reg, _ = jmodel.apply({"params": params}, jb,
                                      regularization=0.1)
        return (logits * jnp.asarray(w)).sum() + 0.1 * reg, logits

    (jval, jlogits), jgrads = jax.value_and_grad(jloss, has_aux=True)(
        variables["params"])
    assert any(s[-1] == 128 for s in jcalls), jcalls

    tcalls = []
    t_fwd = tfl.flash_fwd
    monkeypatch.setattr(tfl, "flash_fwd", lambda *a, **k: (
        tcalls.append((k.get("xa", a[0] if a else None).shape[-1],
                       k.get("vw", a[5] if len(a) > 5 else None).shape[-1])),
        t_fwd(*a, **k))[1])
    make = lambda: _port_model("molhiv", 1, WIDE, variables, "flash")
    port = make().train()
    logits, reg, _ = port(tbatch.collate_graphs(tg, max_nodes=N_MAX),
                          regularization=0.1)
    loss = (logits * _t(w)).sum() + 0.1 * reg
    loss.backward()
    assert sorted(set(tcalls)) == [(128, 16), (128, 128)], tcalls
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               **MODEL_TOL)
    np.testing.assert_allclose(float(loss.detach()), float(jval), **MODEL_TOL)
    want = dict(from_flax({"params": _np(jgrads)}, make()).named_parameters())
    for name, p in port.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(),
                                   want[name].detach().numpy(),
                                   err_msg=name, **GRAD_TOL)


def _same_graphs(jgs, tgs):
    assert len(jgs) == len(tgs)
    for jg, tg in zip(jgs, tgs):
        for field in ("x", "edge_index", "edge_attr", "edge_type", "degree"):
            a, b = getattr(tg, field), getattr(jg, field)
            assert a.dtype == b.dtype, field
            np.testing.assert_array_equal(a, b, err_msg=field)
        np.testing.assert_array_equal(np.asarray(tg.y), np.asarray(jg.y))
        assert np.asarray(tg.y).dtype == np.asarray(jg.y).dtype


@pytest.mark.parametrize("name", ["ogbg-molhiv", "ogbg-molpcba"])
def test_ogb_reader_matches_jax(name):
    """load_ogb_graphs, load_ogb_split_idx and load_ogb (with and without
    the size filter, and a cut graph table) on the fixtures: the same
    arrays, NaN labels in the same places, the same splits."""
    jgs = jogb_raw.load_ogb_graphs(FIXTURES, name)
    tgs = togb_raw.load_ogb_graphs(FIXTURES, name)
    _same_graphs(jgs, tgs)
    ys = np.array([np.asarray(g.y) for g in tgs], dtype=np.float32)
    assert (name == "ogbg-molpcba") == bool(np.isnan(ys).any())
    jidx = jogb_raw.load_ogb_split_idx(FIXTURES, name)
    tidx = togb_raw.load_ogb_split_idx(FIXTURES, name)
    for split in ("train", "valid", "test"):
        np.testing.assert_array_equal(tidx[split], jidx[split])
    for kw in ({}, {"min_nodes": 6}, {"max_graphs": 6}):
        for a, b in zip(jogb_raw.load_ogb(FIXTURES, name, **kw),
                        togb_raw.load_ogb(FIXTURES, name, **kw)):
            _same_graphs(a, b)
    assert togb_raw.find_ogb_root(FIXTURES, name) == FIXTURES
    assert togb_raw.find_ogb_root("/nonexistent", name) is None
    tr, va, te, real = togb_raw.load_ogb_or_synthetic(
        "/nonexistent", name, lambda: t_ogb_like(0, 10))
    assert not real and (len(tr), len(va), len(te)) == (8, 1, 1)
    tr, _, _, real = togb_raw.load_ogb_or_synthetic(FIXTURES, name, list)
    assert real and len(tr) == len(jogb_raw.load_ogb(FIXTURES, name)[0])


def test_fixture_molecules_serve_as_in_jax():
    """The molhiv fixture read by both readers and served by both models:
    its atom ids run past OGB's vocabularies (tests/fixtures/
    make_fixtures.py draws 0-19 in every column), so both sides give NaN
    logits; with each id taken modulo its vocabulary both agree."""
    jgs = jogb_raw.load_ogb_graphs(FIXTURES, "ogbg-molhiv")
    tgs = togb_raw.load_ogb_graphs(FIXTURES, "ogbg-molhiv")
    jb = jbatch.collate_graphs(jgs, max_nodes=N_MAX)
    jmodel, variables = _jax_model("molhiv", 1, SMALL, jb)
    port = _port_model("molhiv", 1, SMALL, variables, "flash").eval()
    dims = np.array(togb.ATOM_FEATURE_DIMS, np.int32)
    for fold in (False, True):
        if fold:
            jgs = [dataclasses.replace(g, x=g.x % dims) for g in jgs]
            tgs = [dataclasses.replace(g, x=g.x % dims) for g in tgs]
        want = np.asarray(jmodel.apply(
            variables, jbatch.collate_graphs(jgs, max_nodes=N_MAX))[0])
        got = TPredictor(port, device="cpu", max_batch=4,
                         collate_kwargs={"max_nodes": N_MAX}).predict(tgs)
        assert np.isfinite(got).all() == fold
        np.testing.assert_allclose(got, want, equal_nan=True, **MODEL_TOL)
