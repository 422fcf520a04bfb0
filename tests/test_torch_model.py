"""The port's SBM node classifier and Predictor vs the JAX package, on the
CPU, plus the port's package rules (no JAX imports, CUDA by default).

The JAX model is forced onto its flash path (Pallas kernels interpreted),
the path it takes at the slice's N >= 1024 on the chip; the port runs the
kernels' plain versions on CPU tensors. Tolerance rtol 5e-4 / atol 5e-5:
f32 through two attention layers, batch norm with non-trivial running
statistics, the coefficient head and the Chebyshev filter, with sums taken
in different orders on the two sides.
"""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.experimental.pallas as pl
import jax.numpy as jnp

import feta_tmlr_tpu.config as jcfg
from feta_tmlr_tpu.data import batch as jbatch
from feta_tmlr_tpu.data.synthetic import sbm_like_dataset as j_sbm
from feta_tmlr_tpu.nn import models as jmodels
from feta_tmlr_tpu.ops.pallas import flash_attention as jfl
from feta_tmlr_tpu.pe import encodings as jpe
from feta_tmlr_tpu.serve import Predictor as JPredictor
from feta_tmlr_tpu_torch.convert import from_flax
from feta_tmlr_tpu_torch.data import batch as tbatch
from feta_tmlr_tpu_torch.data.synthetic import sbm_like_dataset as t_sbm
from feta_tmlr_tpu_torch.nn import models as tmodels
from feta_tmlr_tpu_torch.pe import encodings as tpe
from feta_tmlr_tpu_torch.serve import Predictor as TPredictor

TOL = dict(rtol=5e-4, atol=5e-5)
ROOT = Path(__file__).resolve().parents[1]
CFG = dict(in_size=3, nb_class=2, d_model=16, nb_heads=2, dim_feedforward=32,
           dropout=0.0, nb_layers=2, batch_norm=True, lap_pos_enc=True,
           lap_pos_enc_dim=4, filter_order=3)
N_MAX = 32


@pytest.fixture
def jax_flash_path(monkeypatch):
    orig = pl.pallas_call
    monkeypatch.setattr(jfl.pl, "pallas_call",
                        lambda *a, **k: orig(*a, interpret=True, **k))
    monkeypatch.setenv("FETA_PALLAS", "1")
    monkeypatch.setattr(jcfg, "_on_accelerator", lambda: True)
    monkeypatch.setattr(jcfg, "PALLAS_AUTO_N", 0)


def _graphs(seed=4, n_graphs=3):
    jg = j_sbm(seed=seed, n_graphs=n_graphs, n_nodes=N_MAX)
    tg = t_sbm(seed=seed, n_graphs=n_graphs, n_nodes=N_MAX)
    for enc in (jpe.DiffusionEncoding(beta=1.0), jpe.LapEncoding(4)):
        enc.apply_to(jg)
    for enc in (tpe.DiffusionEncoding(beta=1.0), tpe.LapEncoding(4)):
        enc.apply_to(tg)
    return jg, tg


def _jax_model_and_variables(jg):
    model = jmodels.DiffGraphTransformerGenGCNSBM(**CFG)
    batch = jbatch.collate_graphs(jg, max_nodes=N_MAX, node_labels=True)
    variables = dict(model.init(jax.random.key(0), batch))
    rng = np.random.default_rng(11)
    variables["params"] = jax.tree.map(       # non-zero biases everywhere
        lambda p: p + 0.05 * rng.standard_normal(p.shape).astype(np.float32),
        variables["params"])
    variables["batch_stats"] = jax.tree_util.tree_map_with_path(
        lambda path, a: (rng.random(a.shape) + 0.5 if path[-1].key == "var"
                         else 0.3 * rng.standard_normal(a.shape)
                         ).astype(np.float32),
        jax.tree.map(np.asarray, variables["batch_stats"]))
    return model, variables, batch


def _port_model(variables):
    model = tmodels.DiffGraphTransformerGenGCNSBM(**CFG, device="cpu")
    return from_flax(jax.tree.map(np.asarray, variables), model)


def test_sbm_model_logits_match_jax(jax_flash_path):
    jg, tg = _graphs()
    jmodel, variables, jb = _jax_model_and_variables(jg)
    want, want_reg = jmodel.apply(variables, jb, regularization=0.1)
    port = _port_model(variables).eval()
    tb = tbatch.collate_graphs(tg, max_nodes=N_MAX, node_labels=True)
    with torch.inference_mode():
        got, got_reg = port(tb, regularization=0.1)
    assert got.shape == (3, N_MAX, 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(float(got_reg), float(want_reg), **TOL)


def test_predictor_node_level_matches_jax(jax_flash_path):
    jg, tg = _graphs(seed=6, n_graphs=5)
    jmodel, variables, _ = _jax_model_and_variables(jg)
    kw = dict(max_batch=2, node_level=True,
              collate_kwargs={"max_nodes": N_MAX, "node_labels": True})
    want = JPredictor(jmodel, variables=variables, **kw).predict(jg)
    pred = TPredictor(_port_model(variables), device="cpu", **kw)
    got = pred.predict(tg)                   # chunks of 2, 2, 1
    assert len(got) == len(want) == 5
    for g, w, graph in zip(got, want, tg):
        assert g.shape == (graph.num_nodes, 2)
        np.testing.assert_allclose(g, np.asarray(w), **TOL)
    assert pred.predict([]).size == 0


@pytest.mark.parametrize("reg_type", ["pairwise", "max"])
def test_coefficient_regularizer_matches_jax(reg_type):
    rng = np.random.default_rng(12)
    coeff = rng.standard_normal((3, 4, 9)).astype(np.float32)
    want = jmodels.coefficient_regularizer(jnp.asarray(coeff), reg_type)
    got = tmodels.coefficient_regularizer(torch.from_numpy(coeff), reg_type)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_from_flax_rejects_missing_and_unused_leaves():
    jg, _ = _graphs(n_graphs=2)
    _, variables, _ = _jax_model_and_variables(jg)
    params = jax.tree.map(np.asarray, variables["params"])
    extra = {"params": {**params, "stray": {"kernel": np.zeros((2, 2))}},
             "batch_stats": variables["batch_stats"]}
    with pytest.raises(KeyError, match="stray"):
        _port_model(extra)
    missing = {"params": params}                # no batch_stats
    with pytest.raises(KeyError, match="batch_stats"):
        _port_model(missing)


def test_port_never_imports_jax():
    """The port stands alone: no module of it, nor chip_smoke.py, imports
    jax, flax or the JAX package (numpy-only modules included)."""
    banned = ("jax", "flax", "feta_tmlr_tpu")
    files = sorted((ROOT / "feta_tmlr_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 15
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                assert top not in banned, f"{path.name} imports {name}"


def test_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tmodels.DiffGraphTransformerGenGCNSBM(**CFG)
    model = tmodels.DiffGraphTransformerGenGCNSBM(**CFG, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TPredictor(model)
    assert TPredictor(model, device="cpu").device.type == "cpu"


def test_float64_cpu_route_matches_float32():
    """A float64 model on the CPU keeps float64 through the attention (a
    reference run) and agrees with the float32 route to f32 precision."""
    _, tg = _graphs(n_graphs=2)
    tb = tbatch.collate_graphs(tg, max_nodes=N_MAX, node_labels=True)
    tb64 = tbatch.GraphBatch(**{
        k: v.double() if torch.is_tensor(v) and v.is_floating_point() else v
        for k, v in vars(tb).items()})
    m32 = tmodels.DiffGraphTransformerGenGCNSBM(**CFG, device="cpu")
    m64 = tmodels.DiffGraphTransformerGenGCNSBM(
        **CFG, device="cpu").to(torch.float64)
    m64.load_state_dict(m32.state_dict())
    got, _ = m64.train()(tb64)
    want, _ = m32.train()(tb)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(),
                               rtol=1e-4, atol=1e-5)
    got.sum().backward()
    assert all(p.grad.dtype == torch.float64 for p in m64.parameters())


def test_model_init_is_seeded():
    a = tmodels.DiffGraphTransformerGenGCNSBM(**CFG, seed=3, device="cpu")
    b = tmodels.DiffGraphTransformerGenGCNSBM(**CFG, seed=3, device="cpu")
    c = tmodels.DiffGraphTransformerGenGCNSBM(**CFG, seed=4, device="cpu")
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not all(torch.equal(sa[k], sc[k]) for k in sa)
