"""The GraphiT + GCKN CLIs (`run_transformer_gckn{,_cv,_SBM_cv,_molhiv}`)
and the supervised GCKN CLIs (`gckn_sup{,_cv}`) on the CPU against the JAX
CLIs they mirror, as `tests/test_torch_cli_gckn.py` sets out (the same
helpers and tolerances)."""

import ast
import importlib

import numpy as np
import pytest
import torch

from test_torch_cli_gckn import (
    ADAM_TOL,
    FIXTURES,
    ROW_TOL,
    check_transformer_cli,
)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Many small torch ops: one intra-op thread each, where the suite's
    parallel workers would otherwise oversubscribe the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("module,extra,metric", [
    ("run_transformer_gckn", [], "mae"),
    ("run_transformer_gckn_cv", ["--datadir", FIXTURES, "--dataset",
                                 "TUFIX"], "acc"),
    ("run_transformer_gckn_SBM_cv",
     ["--datadir", FIXTURES, "--dataset", "FIXTURE", "--gckn-path", "2"],
     "acc_sbm"),
    ("run_transformer_gckn_molhiv", [], "rocauc"),
], ids=["graphit_zinc", "graphit_cv", "graphit_sbm", "graphit_molhiv"])
def test_gckn_graphit_cli_matches_jax_cli(module, extra, metric, tmp_path):
    check_transformer_cli(module, extra, metric, tmp_path)


def _rows(text):
    return [ast.literal_eval(line) for line in text.splitlines()
            if line.startswith("{'epoch'")]


@pytest.mark.parametrize("module,argv", [
    ("gckn_sup", ["--synthetic-graphs", "20", "--path-size", "3"]),
    ("gckn_sup", ["--synthetic-graphs", "20", "--path-size", "3",
                  "--aggregation", "--pooling", "mean"]),
    ("gckn_sup_cv", ["--synthetic-graphs", "30", "--datadir",
                     "no-such-dir"]),
], ids=["sup", "sup_agg", "sup_cv"])
def test_gckn_supervised_cli_matches_jax_cli(module, argv, capsys):
    """The printed rows (epochs 0, 10 and the last of 12) and the returned
    test metric against the JAX CLI's (the module docstring's
    tolerances)."""
    jmain = importlib.import_module(
        f"feta_tmlr_tpu.experiments.{module}").main
    tmain = importlib.import_module(
        f"feta_tmlr_tpu_torch.experiments.{module}").main
    argv = argv + ["--epochs", "12", "--hidden-size", "8",
                   "--n-sampling-paths", "300"]
    want = jmain(argv)
    want_rows = _rows(capsys.readouterr().out)
    got = tmain(argv + ["--device", "cpu"])
    got_rows = _rows(capsys.readouterr().out)
    assert [sorted(r) for r in got_rows] == [sorted(r) for r in want_rows]
    assert [r["epoch"] for r in got_rows] == [0, 10, 11]
    np.testing.assert_allclose(got_rows[0]["loss"], want_rows[0]["loss"],
                               **ROW_TOL)
    for g, w in zip(got_rows, want_rows):
        for key in g:
            np.testing.assert_allclose(g[key], w[key], **ADAM_TOL,
                                       err_msg=f"{module} {key}")
    np.testing.assert_allclose(got, want, **ADAM_TOL)
