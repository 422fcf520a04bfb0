"""The port's GraphiT baseline CLIs (`run_transformer{,_cv,_SBM_cv,_molhiv}`,
`run_transformer_gcn{,_cv}`), feta-zinc with the FeTA filter's options, and
the TU config trainer (`main_TU_graph_classification`, all eight model
names), end to end on the CPU against the JAX CLIs they mirror: the same
result keys, the same `logs.csv` and `results.csv` columns (or, for the TU
trainer, the same printed rows), finite losses, a checkpoint per epoch and
a `--resume` run that continues from it (tests/test_torch_cli.py's
`_run_pair`). The JAX CLI runs one epoch at a tiny width; the port's two.
Data: tests/fixtures (the ZINC molecules, TUFIX, the SBM fixture) or the
synthetic fallbacks.
"""

import ast
import json
import os

import numpy as np
import pytest
import torch

from feta_tmlr_tpu_torch.experiments import (
    main_TU_graph_classification as ttu,
    run_transformer as tgraphit,
    run_transformer_cv as tgraphit_cv,
    run_transformer_gcn as tgcn,
    run_transformer_gcn_cv as tgcn_cv,
    run_transformer_gengcn as tzinc,
    run_transformer_molhiv as tmolhiv,
    run_transformer_SBM_cv as tsbm,
)
from test_torch_cli import _run_pair

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
ZINC = ["--datadir", FIXTURES, "--lappe", "--lap-dim", "4", "--pos-enc",
        "diffusion"]
TU = ["--datadir", FIXTURES, "--dataset", "TUFIX", "--lappe", "--lap-dim",
      "2"]


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Many small torch ops: one intra-op thread each, where the suite's
    parallel workers would otherwise oversubscribe the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("module,extra", [
    ("run_transformer", ZINC), ("run_transformer", ZINC + ["--vanilla"]),
    ("run_transformer_gcn", ZINC), ("run_transformer_cv", TU),
    ("run_transformer_gcn_cv", TU),
    ("run_transformer_SBM_cv", ["--datadir", FIXTURES, "--dataset",
                                "FIXTURE", "--lappe", "--lap-dim", "2"]),
    ("run_transformer_molhiv", []),
], ids=["zinc", "vanilla", "gcn", "cv", "gcn_cv", "sbm", "molhiv"])
def test_graphit_cli_matches_jax_cli(module, extra, tmp_path):
    import importlib
    jmain = importlib.import_module(
        f"feta_tmlr_tpu.experiments.{module}").main
    tmain = {"run_transformer": tgraphit, "run_transformer_gcn": tgcn,
             "run_transformer_cv": tgraphit_cv,
             "run_transformer_gcn_cv": tgcn_cv,
             "run_transformer_SBM_cv": tsbm,
             "run_transformer_molhiv": tmolhiv}[module].main
    got = _run_pair(jmain, tmain, extra, tmp_path)
    assert sorted(got["test"]) == (["rocauc"] if "molhiv" in module else
                                   [{"gcn_cv": "acc", "cv": "acc"}.get(
                                       module.split("transformer_")[-1],
                                       "acc_sbm" if "SBM" in module
                                       else "mae")])


@pytest.mark.parametrize("option", [["--gnn_type", "ARMAConvDynamic"],
                                    ["--last_layer_filter"]],
                         ids=["arma", "every-layer"])
def test_zinc_cli_filter_options_match_jax_cli(option, tmp_path):
    """feta-zinc with the ARMA filter and with the filter in every layer
    (once refused); `--packed` still refuses
    (tests/test_torch_entry.py)."""
    from feta_tmlr_tpu.experiments import run_transformer_gengcn as jzinc
    got = _run_pair(jzinc.main, tzinc.main, ZINC + option, tmp_path)
    assert "mae" in got["test"]


def _tiny_config(tmp_path, name):
    path = tmp_path / f"{name}.json"
    path.write_text(json.dumps({
        "model": name, "params": {"epochs": 1, "batch_size": 8},
        "net_params": {"L": 1, "hidden_dim": 16, "out_dim": 16,
                       "n_heads": 2, "LPE_dim": 4, "LPE_n_heads": 2,
                       "LPE_layers": 1, "pos_enc_dim": 4}}))
    return str(path)


def _rows(text):
    return [ast.literal_eval(line) for line in text.splitlines()
            if line.startswith("{'epoch'")]


@pytest.fixture(scope="module")
def jax_tu_run(tmp_path_factory):
    """The JAX TU trainer once (GraphiT, the tiny config): its result keys
    and printed rows' keys, which its eight names share (one `fit`, one
    log row format)."""
    import contextlib
    import io

    from feta_tmlr_tpu.experiments import main_TU_graph_classification as jtu
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = jtu.main(["--config", _tiny_config(
            tmp_path_factory.mktemp("jax_tu"), "GraphiT"), "--dataset",
            "TUFIX", "--datadir", FIXTURES, "--max_freqs", "3", "--epochs",
            "1"])
    return sorted(res), [list(r) for r in _rows(out.getvalue())], \
        sorted(jtu.MODELS)


@pytest.mark.parametrize("name", sorted(ttu.MODELS))
def test_tu_trainer_matches_jax_trainer(name, jax_tu_run, tmp_path, capsys):
    """Each of the eight names (JAX's `MODELS`) on TUFIX (float features,
    no bond types), one epoch: the JAX trainer's result keys and printed
    rows' keys; a resumed epoch, its row written to logs.csv with
    --outdir."""
    keys, rows, names = jax_tu_run
    assert sorted(ttu.MODELS) == names
    argv = ["--config", _tiny_config(tmp_path, name), "--dataset", "TUFIX",
            "--datadir", FIXTURES, "--max_freqs", "3", "--epochs", "1"]
    ckpt = str(tmp_path / "ckpt")
    got = ttu.main(argv + ["--device", "cpu", "--ckpt-dir", ckpt])
    got_rows = _rows(capsys.readouterr().out)
    assert sorted(got) == keys
    assert [list(r) for r in got_rows] == rows
    assert all(np.isfinite(r["loss"]) for r in got_rows)
    resumed = ttu.main(argv[:-1] + ["2", "--device", "cpu", "--ckpt-dir",
                                    ckpt, "--resume", "--outdir",
                                    str(tmp_path / "out")])
    assert [r["epoch"] for r in resumed["history"]] == [1]
    with open(tmp_path / "out" / "logs.csv") as f:
        assert f.readline().strip().split(",") == list(got_rows[0])


def test_tu_trainer_synthetic_fallback_and_unknown_name(tmp_path):
    res = ttu.main(["--model", "GraphiT", "--datadir", str(tmp_path),
                    "--epochs", "1", "--synthetic-graphs", "30",
                    "--device", "cpu"])
    assert [r["epoch"] for r in res["history"]] == [0]
    with pytest.raises(SystemExit, match="unknown model"):
        ttu.main(["--model", "GAT", "--device", "cpu"])
