"""The LPE tier's configs and config-driven entry points in the port, on
the CPU.

Every file under configs/LPE/ resolves through the trainer of its
dataset (ZINC, SBM_PATTERN / SBM_CLUSTER or MOL-HIV) with no --model
override, builds at its own widths and takes one training step on two
tiny graphs; the ZINC ones resolve to the JAX trainer's class and
arguments. The SBM and molhiv trainers run two epochs and a resumed one
(synthetic SBMs; the ogbg-molhiv fixture under tests/fixtures), and
serve_main answers from a GATFeTA checkpoint with the logits of an
in-process Predictor restored from it (within 1e-5: the same weights,
inputs and code on both sides).
"""

import csv
import json
import os
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from feta_tmlr_tpu_torch.data.batch import collate_graphs
from feta_tmlr_tpu_torch.data.sbm import load_sbm_or_synthetic
from feta_tmlr_tpu_torch.data.synthetic import zinc_categorical_dataset
from feta_tmlr_tpu_torch.experiments import main_molhiv_graph_classification \
    as tmolhiv
from feta_tmlr_tpu_torch.experiments import main_SBMs_node_classification \
    as tsbm
from feta_tmlr_tpu_torch.experiments import main_ZINC_graph_regression as tmain
from feta_tmlr_tpu_torch.experiments import serve_main
from feta_tmlr_tpu_torch.nn.gat import GATFeTANet, GATNet
from feta_tmlr_tpu_torch.pe.laplace import apply_laplace_decomp
from feta_tmlr_tpu_torch.serve import Predictor
from feta_tmlr_tpu_torch.train.trainer import TrainConfig, Trainer
from feta_tmlr_tpu_torch.utils.config import load_config

ROOT = Path(__file__).resolve().parents[1]
FIXTURES = str(ROOT / "tests" / "fixtures")
LPE_CONFIGS = sorted(str(p.relative_to(ROOT))
                     for p in (ROOT / "configs" / "LPE").rglob("*.json"))


@pytest.fixture(autouse=True)
def one_torch_thread():
    """These tests run many small torch ops: one intra-op thread each,
    where the suite's parallel workers would otherwise oversubscribe the
    cores (the setting is restored after each test)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _tiny_graphs(dataset):
    """(two small graphs, task, collate kwargs, build) for a config's
    dataset, through its trainer's own pieces."""
    smallest = lambda gs: sorted(gs, key=lambda g: g.num_nodes)[:2]
    if dataset == "ZINC":
        return (smallest(zinc_categorical_dataset(seed=2, n_graphs=8)),
                "graph_reg", {},
                lambda cls, kw: tmain.construct_model(cls, kw, "cpu"))
    if dataset.startswith("SBM_"):
        tr, _, _, _ = load_sbm_or_synthetic("no-such-dir", dataset,
                                            n_synthetic=4, n_nodes=10)
        return (tr[:2], "node_clf", {"node_labels": True},
                lambda cls, kw: tsbm.construct_model(cls, kw, 3, 2, "cpu"))
    return (smallest(tmolhiv.molhiv_like(2, 8)), "binary_graph", {},
            lambda cls, kw: tmolhiv.construct_model(cls, kw, "cpu"))


def _resolve(cfg):
    if cfg["dataset"] == "ZINC":
        return tmain.resolve_build(cfg)
    if cfg["dataset"].startswith("SBM_"):
        return tsbm.resolve_build(cfg)
    return tmolhiv.resolve_build(cfg)


@pytest.mark.parametrize("path", LPE_CONFIGS)
def test_lpe_config_builds_at_its_widths_and_steps(path):
    cfg = load_config(str(ROOT / path))
    net = cfg["net_params"]
    cls, kwargs = _resolve(cfg)
    if cfg["dataset"] == "ZINC":
        from feta_tmlr_tpu.experiments import main_ZINC_graph_regression \
            as jmain
        jcls, jkwargs = jmain.resolve_build(cfg)
        assert (jcls.__name__, jkwargs) == (cls.__name__, kwargs)
    graphs, task, collate, build = _tiny_graphs(cfg["dataset"])
    if cls not in (GATNet, GATFeTANet):
        apply_laplace_decomp(graphs, 10)
    model = build(cls, kwargs)
    layers = net.get("GT_layers", net.get("L"))
    assert len(model.layers) == layers
    if cls in (GATNet, GATFeTANet):
        assert model.layers[0].gatconv.fc.out_features == \
            net["hidden_dim"] * net["n_heads"]
        assert model.mlp_readout.fc_0.in_features == net["out_dim"]
        # no last_layer_filter in the GAT nets: the filter in every layer
        assert all(hasattr(layer, "cheb_weight") == (cls is GATFeTANet)
                   for layer in model.layers)
    else:
        assert model.layers[0].out_dim == net["GT_hidden_dim"]
        assert model.layers[-1].out_dim == net["GT_out_dim"]
        assert model.layers[0].num_heads == net["GT_n_heads"]
        assert hasattr(model.layers[0].attention, "Q_2") == \
            net["full_graph"]
        if net["LPE"] != "none":
            assert model.pe_transformer.lpe_dim == net["LPE_dim"]
        if net.get("last_layer_filter") and net["LPE"] == "spectral_node":
            assert [hasattr(layer, "cheb_weight")
                    for layer in model.layers] == [False] * (layers - 1) \
                + [True]
    batch = collate_graphs(graphs, **collate)
    trainer = Trainer(model, TrainConfig(task=task, lr=1e-4,
                                         sign_flip=cls not in (GATNet,
                                                               GATFeTANet)))
    loss = float(trainer.step(batch))
    assert np.isfinite(loss)
    assert all(torch.isfinite(p.grad).all() for p in model.parameters()
               if p.grad is not None)


def test_every_lpe_config_is_covered():
    datasets = sorted({load_config(str(ROOT / p))["dataset"]
                       for p in LPE_CONFIGS})
    assert len(LPE_CONFIGS) == 36
    assert datasets == ["MOL-HIV", "SBM_CLUSTER", "SBM_PATTERN", "ZINC"]


@pytest.mark.parametrize("name", ["GraphiTSpectra", "Spectra", "GraphiT"])
def test_sbm_trainer_resolves_the_lspe_names_like_jax(name):
    """The JAX SBM trainer's class and fixed arguments for the LSPE names,
    with its defaults (pos_enc_dim 12, widths 32, 4 heads, 3 layers)."""
    from feta_tmlr_tpu.experiments import main_SBMs_node_classification \
        as jsbm
    cls, kwargs = tsbm.resolve_build({"net_params": {}}, name)
    jcls, jextra = jsbm.MODELS[name]
    assert cls.__name__ == jcls.__name__ == "GraphiTSpectraNet"
    assert kwargs == dict(jextra, hidden_dim=32, out_dim=32, n_heads=4,
                          n_layers=3, pos_enc_dim=12)


def _header(path):
    with open(path) as f:
        return next(csv.reader(f))


def _check_run(main, argv, tmp_path, metric):
    """Two epochs into a checkpoint directory, then one resumed."""
    ckpt, out = str(tmp_path / "ckpt"), str(tmp_path / "out")
    common = argv + ["--ckpt-dir", ckpt, "--device", "cpu"]
    got = main(common + ["--epochs", "2", "--outdir", out])
    assert [r["epoch"] for r in got["history"]] == [0, 1]
    assert all(np.isfinite(r["loss"]) for r in got["history"])
    assert _header(os.path.join(out, "logs.csv")) == [
        "epoch", "loss", "time", metric, "lr"]
    assert _header(os.path.join(out, "results.csv"))[0] == "best_val"
    resumed = main(common + ["--epochs", "3", "--resume"])
    assert [r["epoch"] for r in resumed["history"]] == [2]
    return got


def test_sbm_trainer_two_epochs_and_resume(tmp_path):
    got = _check_run(tsbm.main, [
        "--model", "SAN_NodeLPE", "--synthetic-graphs", "10",
        "--n-nodes", "12", "--data-dir", "no-such-dir"], tmp_path,
        "val_acc_sbm")
    assert 0.0 <= got["best_val"] <= 1.0


def test_molhiv_trainer_on_the_ogb_fixture(tmp_path):
    """configs/LPE/MOLHIV/optimized_spectral_full_1.json as written
    (SAN_NodeSpectra, 10 layers of width 64, layer dropout 0.01, sum
    readout) on the fixture's molecules, atom features cut to one id."""
    _check_run(tmolhiv.main, [
        "--config", str(ROOT / "configs/LPE/MOLHIV/"
                        "optimized_spectral_full_1.json"),
        "--data-dir", FIXTURES], tmp_path, "val_rocauc")


def _post_graphs(port, graphs):
    payload = {"graphs": [{"x_int": g.x.reshape(-1).tolist(),
                           "edge_index": g.edge_index.tolist(),
                           "edge_type": g.edge_type.tolist()}
                          for g in graphs]}
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/predict", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return np.asarray(json.loads(r.read())["logits"], np.float32)


def test_serve_main_serves_a_gat_feta_checkpoint(tmp_path):
    cfg = str(ROOT / "configs/LPE/ZINC_GATFeTA_optimized.json")
    ckpt = str(tmp_path / "ckpt")
    tmain.main(["--config", cfg, "--data-dir", FIXTURES, "--epochs", "1",
                "--ckpt-dir", ckpt, "--device", "cpu"])
    srv, port, _ = serve_main.main(
        ["--config", cfg, "--ckpt-dir", ckpt, "--warmup", "--port", "0",
         "--max-batch", "4", "--max-nodes", "32", "--device", "cpu"],
        background=True)
    try:
        graphs = zinc_categorical_dataset(seed=9, n_graphs=6)
        served = _post_graphs(port, graphs)
    finally:
        srv.shutdown()
        srv.server_close()
    model, preprocess, _ = serve_main.build_from_config(cfg, device="cpu")
    assert isinstance(model, GATFeTANet) and len(model.layers) == 16
    preprocess(graphs)
    direct = Predictor(model, device="cpu", ckpt_dir=ckpt, max_batch=4,
                       collate_kwargs={"max_nodes": 32}).predict(graphs)
    assert served.shape == (6, 1) and np.isfinite(served).all()
    np.testing.assert_allclose(served, direct, rtol=1e-5, atol=1e-5)
