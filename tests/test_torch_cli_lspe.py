"""The LSPE tier's configs and config-driven entry points in the port, on
the CPU.

Every file under configs/LSPE/ resolves through the trainer of its
dataset (ZINC, SBM PATTERN, or the new OGBMOL trainer for MOLTOX21 /
MOLPCBA) with no --model override, builds at its own widths and takes one
training step on two tiny graphs. The ZINC ones resolve to the JAX
trainer's class and arguments; PNA also takes the config's
`PNA_NET_PARAMS`, which the JAX trainers drop. The OGBMOL trainer runs two
epochs and resumes bit for bit on the ogbg-molpcba fixture, with the JAX
trainer's result keys and the row keys of its log as logs.csv's columns,
and on synthetic MOLTOX21 molecules; the ZINC trainer resumes the lapeig
config bit for bit. serve_main answers from a GraphiT-Spectra-LSPE
checkpoint with the logits of an in-process Predictor restored from it
(within 1e-5), and refuses PNA without net_params.avg_d_log with the JAX
package's message.
"""

import csv
import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from feta_tmlr_tpu_torch.data.batch import collate_graphs
from feta_tmlr_tpu_torch.data.sbm import load_sbm_or_synthetic
from feta_tmlr_tpu_torch.data.synthetic import zinc_categorical_dataset
from feta_tmlr_tpu_torch.experiments import \
    main_OGBMOL_graph_classification as togb
from feta_tmlr_tpu_torch.experiments import main_SBMs_node_classification \
    as tsbm
from feta_tmlr_tpu_torch.experiments import main_ZINC_graph_regression as tmain
from feta_tmlr_tpu_torch.experiments import serve_main
from feta_tmlr_tpu_torch.experiments.common import (
    PNA_NET_PARAMS,
    lspe_precompute,
    pna_kwargs,
)
from feta_tmlr_tpu_torch.nn.lspe import GraphiTSpectraNet
from feta_tmlr_tpu_torch.nn.pna import PNALSPENet
from feta_tmlr_tpu_torch.serve import Predictor
from feta_tmlr_tpu_torch.train.trainer import TrainConfig, Trainer
from feta_tmlr_tpu_torch.utils.config import load_config
from test_torch_cli_lpe import _post_graphs

ROOT = Path(__file__).resolve().parents[1]
FIXTURES = str(ROOT / "tests" / "fixtures")
LSPE_CONFIGS = sorted(str(p.relative_to(ROOT))
                      for p in (ROOT / "configs" / "LSPE").glob("*.json"))


@pytest.fixture(autouse=True)
def one_torch_thread():
    """These tests run many small torch ops: one intra-op thread each,
    where the suite's parallel workers would otherwise oversubscribe the
    cores (the setting is restored after each test)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _build(cfg):
    """(model, two tiny graphs with their PEs, task, collate kwargs)
    through the config's trainer."""
    smallest = lambda gs: sorted(gs, key=lambda g: g.num_nodes)[:2]
    if cfg["dataset"] == "ZINC":
        cls, kw = tmain.resolve_build(cfg)
        graphs = smallest(zinc_categorical_dataset(seed=2, n_graphs=8))
        tmain.pe_precompute(graphs, cls, kw, cfg)
        model = tmain.construct_model(cls, kw, "cpu", avg_d_log=1.1)
        return cls, kw, model, graphs, "graph_reg", {}
    if cfg["dataset"] == "PATTERN":
        cls, kw = tsbm.resolve_build(cfg)
        graphs, _, _, _ = load_sbm_or_synthetic("no-such-dir", "SBM_PATTERN",
                                                n_synthetic=4, n_nodes=10)
        graphs = graphs[:2]
        tsbm.pe_precompute(graphs, cls, kw, cfg)
        model = tsbm.construct_model(cls, kw, 3, 2, "cpu")
        return cls, kw, model, graphs, "node_clf", {"node_labels": True}
    cls, kw = togb.resolve_build(cfg)
    n_tasks = togb.N_TASKS[togb.dataset_of(cfg)]
    graphs = smallest(togb.ogbmol_like(2, 8, n_tasks))
    lspe_precompute(graphs, kw, cfg["net_params"], with_kernel=False)
    if cls is PNALSPENet:
        kw.setdefault("avg_d_log", 1.1)
    model = togb.construct_model(cls, kw, n_tasks, "cpu")
    return cls, kw, model, graphs, "binary_graph", {}


@pytest.mark.parametrize("path", LSPE_CONFIGS)
def test_lspe_config_builds_at_its_widths_and_steps(path):
    cfg = load_config(str(ROOT / path))
    net = cfg["net_params"]
    cls, kwargs, model, graphs, task, collate = _build(cfg)
    if cfg["dataset"] == "ZINC":
        from feta_tmlr_tpu.experiments import main_ZINC_graph_regression \
            as jmain
        jcls, jkwargs = jmain.resolve_build(cfg)
        assert jcls.__name__ == cls.__name__
        assert {k: v for k, v in kwargs.items()
                if k not in PNA_NET_PARAMS} == jkwargs
    else:
        from feta_tmlr_tpu.experiments import (
            main_OGBMOL_graph_classification as jogb,
            main_SBMs_node_classification as jsbm)
        jreg = jsbm.MODELS if cfg["dataset"] == "PATTERN" else jogb.MODELS
        jcls, jextra = jreg[cfg["model"]]
        assert jcls.__name__ == cls.__name__
        assert all(kwargs[k] == v for k, v in jextra.items())
    assert len(model.layers) == net["L"]
    assert model.embedding_h.weight.shape[1] == net["hidden_dim"]
    assert model.mlp_readout.fc_0.in_features == net["out_dim"]
    assert hasattr(model, "embedding_p") == (net["pe_init"] != "no_pe")
    if net["pe_init"] == "rand_walk":
        assert model.embedding_p.in_features == net["pos_enc_dim"]
        assert graphs[0].lap_pe.shape[1] == net["pos_enc_dim"]
    if cls is PNALSPENet:
        assert kwargs == dict(kwargs, **pna_kwargs(net))
        assert model.layers[0].n_towers == net.get("towers", 1)
        assert model.embedding_e.weight.shape[1] == net["edge_dim"]
    if cls is GraphiTSpectraNet:
        assert model.layers[0].num_heads == net["n_heads"]
        assert all(hasattr(layer, "cheb_weight") == (cfg["model"] != "GraphiT")
                   for layer in model.layers)
        adaptive = net["adaptive_edge_PE"] and cfg["dataset"] in ("ZINC",
                                                                  "PATTERN")
        assert (graphs[0].pe is not None) == adaptive
    batch = collate_graphs(graphs, **collate)
    trainer = Trainer(model, TrainConfig(
        task=task, lr=1e-4, sign_flip=False,
        regularization=1.0 if kwargs.get("use_lapeig_loss") else 0.0))
    loss = float(trainer.step(batch))
    assert np.isfinite(loss)
    assert all(torch.isfinite(p.grad).all() for p in model.parameters()
               if p.grad is not None)


def test_every_lspe_config_is_covered():
    datasets = sorted({load_config(str(ROOT / p))["dataset"]
                       for p in LSPE_CONFIGS})
    assert len(LSPE_CONFIGS) == 26
    assert datasets == ["OGBG-MOLPCBA", "OGBG-MOLTOX21", "PATTERN", "ZINC"]


def _history(result):
    return [{k: v for k, v in r.items() if k != "time"}
            for r in result["history"]]


def _header(path):
    with open(path) as f:
        return next(csv.reader(f))


def _check_exact_resume(main, argv, tmp_path):
    """Two epochs into a checkpoint directory and a resume to four, against
    four epochs in one run: every logged number, best_val and every
    weight equal. Returns the 2-epoch run's result and its outdir."""
    ckpt, out = str(tmp_path / "ckpt"), str(tmp_path / "out")
    common = argv + ["--device", "cpu"]
    first = main(common + ["--epochs", "2", "--ckpt-dir", ckpt,
                           "--outdir", out])
    resumed = main(common + ["--epochs", "4", "--ckpt-dir", ckpt,
                             "--resume"])
    full = main(common + ["--epochs", "4"])
    assert [r["epoch"] for r in resumed["history"]] == [2, 3]
    assert _history(first) + _history(resumed) == _history(full)
    assert resumed["best_val"] == full["best_val"]
    for k, v in full["state"].items():
        assert torch.equal(resumed["state"][k], v), k
    return first, out


def test_ogbmol_trainer_on_the_molpcba_fixture(tmp_path):
    """GatedGCN_MOLPCBA_LSPE.json as written (8 layers of width 118, the
    random-walk PE of 20 columns) on the fixture's molecules: the task
    count from its label table, average precision, exact resume; the JAX
    trainer's result keys and log row keys."""
    cfg = str(ROOT / "configs/LSPE/GatedGCN_MOLPCBA_LSPE.json")
    got, out = _check_exact_resume(
        togb.main, ["--config", cfg, "--data-dir", FIXTURES], tmp_path)
    from feta_tmlr_tpu.experiments import main_OGBMOL_graph_classification \
        as jogb
    want = jogb.main(["--model", "GatedGCN", "--dataset", "MOLPCBA",
                      "--data-dir", FIXTURES, "--epochs", "1"])
    assert sorted(got) == sorted(want)
    assert _header(os.path.join(out, "logs.csv")) == list(
        want["history"][0]) == ["epoch", "loss", "time", "val_ap", "lr"]
    assert _header(os.path.join(out, "results.csv")) == [
        "best_val", "test_ap"]
    assert 0.0 <= got["best_val"] <= 1.0


@pytest.mark.parametrize("config,towers", [
    ("GraphiT_MOLTOX21_LSPE.json", None), ("PNA_MOLTOX21_NoPE.json", 1)])
def test_ogbmol_trainer_on_synthetic_moltox21(tmp_path, config, towers):
    """Without a dataset the trainer falls back to synthetic molecules of
    12 tasks (a quarter unlabelled) and selects by ROC-AUC; PNA at the
    config's width 206 runs one tower."""
    res = togb.main(["--config", str(ROOT / "configs/LSPE" / config),
                     "--data-dir", str(tmp_path / "none"), "--epochs", "1",
                     "--synthetic-graphs", "12", "--device", "cpu"])
    assert list(res["history"][0]) == ["epoch", "loss", "time",
                                       "val_rocauc", "lr"]
    assert np.isfinite(res["history"][0]["loss"])
    if towers:
        cls, kw = togb.resolve_build(load_config(
            str(ROOT / "configs/LSPE" / config)))
        assert cls is PNALSPENet and kw["towers"] == towers


def test_zinc_trainer_lapeig_config_resumes_exactly(tmp_path):
    """GatedGCN_ZINC_LSPE_withLapEigLoss.json as written (16 layers of
    width 59, alpha_loss 1): the net returns the lapeig term and the
    trainer adds it (regularization 1); resume is bit-exact."""
    cfg = str(ROOT / "configs/LSPE/GatedGCN_ZINC_LSPE_withLapEigLoss.json")
    _check_exact_resume(tmain.main, ["--config", cfg, "--data-dir",
                                     FIXTURES], tmp_path)
    cls, kw = tmain.resolve_build(load_config(cfg))
    graphs = zinc_categorical_dataset(seed=1, n_graphs=4)
    tmain.pe_precompute(graphs, cls, kw, load_config(cfg))
    model = tmain.construct_model(cls, kw, "cpu")
    logits, aux = model(collate_graphs(graphs))
    assert logits.shape == (4, 1) and aux.shape == ()
    assert float(aux.detach()) > 0


def test_sbm_trainer_pattern_lspe_config(tmp_path):
    """GraphiT_SBM_PATTERN_LSPE.json as written (Spectra, 10 layers of
    width 48, RWPE 16, the adaptive kernel of 16 steps) on synthetic SBMs:
    two epochs and a bit-exact resume; no sign flips."""
    cfg = str(ROOT / "configs/LSPE/GraphiT_SBM_PATTERN_LSPE.json")
    got, out = _check_exact_resume(
        tsbm.main, ["--config", cfg, "--data-dir", "no-such-dir",
                    "--synthetic-graphs", "6", "--n-nodes", "12"], tmp_path)
    assert _header(os.path.join(out, "logs.csv")) == [
        "epoch", "loss", "time", "val_acc_sbm", "lr"]
    assert 0.0 <= got["best_val"] <= 1.0


def test_serve_main_serves_a_graphit_spectra_lspe_checkpoint(tmp_path):
    """The ZINC trainer's GraphiT_ZINC_LSPE.json checkpoint served: the
    server computes the random-walk PE and the adaptive kernel of each
    request's graphs, and answers with the in-process Predictor's
    logits."""
    cfg = str(ROOT / "configs/LSPE/GraphiT_ZINC_LSPE.json")
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
    assert isinstance(model, GraphiTSpectraNet) and len(model.layers) == 10
    preprocess(graphs)
    assert graphs[0].lap_pe.shape[1] == 16 and graphs[0].pe is not None
    direct = Predictor(model, device="cpu", ckpt_dir=ckpt, max_batch=4,
                       collate_kwargs={"max_nodes": 32}).predict(graphs)
    assert served.shape == (6, 1) and np.isfinite(served).all()
    np.testing.assert_allclose(served, direct, rtol=1e-5, atol=1e-5)


def test_serve_main_refuses_pna_without_avg_d_log(tmp_path):
    """The JAX package's message; with net_params.avg_d_log the model is
    built with that value."""
    cfg = str(ROOT / "configs/LSPE/PNA_ZINC_LSPE.json")
    from feta_tmlr_tpu.experiments import serve_main as jserve
    with pytest.raises(SystemExit) as jexc:
        jserve.build_from_config(cfg)
    with pytest.raises(SystemExit) as exc:
        serve_main.build_from_config(cfg, device="cpu")
    assert str(exc.value) == str(jexc.value)
    assert "avg_d_log" in str(exc.value)
    with_stat = load_config(cfg)
    with_stat["net_params"]["avg_d_log"] = 1.25
    path = tmp_path / "pna.json"
    path.write_text(json.dumps(with_stat))
    model, _, _ = serve_main.build_from_config(str(path), device="cpu")
    assert isinstance(model, PNALSPENet)
    assert model.layers[0].towers.avg_d_log == 1.25


def test_lspe_entry_points_default_to_cuda(monkeypatch):
    """Without a card and without --device cpu the OGBMOL trainer and the
    LSPE nets raise; the port never falls back to the CPU quietly."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        togb.main(["--model", "GatedGCN"])
    for cls in (GraphiTSpectraNet, PNALSPENet):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cls(num_atom_type=4, num_bond_type=2, hidden_dim=8, out_dim=8,
                n_layers=1)
