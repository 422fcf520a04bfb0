"""The port's ten GCKN command-line entry points on the CPU against the JAX
CLIs they mirror (the FeTA four here; the GraphiT four and the two
supervised ones in `tests/test_torch_cli_gckn_graphit.py`, so that the
suite's workers share them). The eight transformer CLIs
(`feta-torch-zinc-gckn` and its TU, SBM and molpcba twins; the GraphiT
ones on ZINC, TU, SBM and molhiv) by `tests/test_torch_cli.py::_run_pair`: the same result keys and
`logs.csv` / `results.csv` columns, finite losses, a checkpoint per epoch
and a `--resume` run that continues from it (their weights come from
different initialisers, so their losses differ). The two supervised GCKN
CLIs start from the same weights as JAX's (k-means centres and numpy
draws), so their printed numbers are held to JAX's: the first loss within
ROW_TOL, every later number within ADAM_TOL (Adam's first steps move
every entry by about lr whatever its gradient's size, so an entry whose
gradient is at float32 rounding level, summed in another order here, may
step the other way). Small runs: synthetic data or the fixtures, paths of at most 4
nodes, GCKN width 4, 300 sampled paths.
"""

import importlib
import os

import pytest
import torch

from test_torch_cli import _run_pair

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
GCKN = ["--gckn-dim", "4", "--n-sampling-paths", "300"]
ROW_TOL = dict(rtol=1e-4, atol=1e-5)
ADAM_TOL = dict(rtol=1e-2, atol=1e-3)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Many small torch ops: one intra-op thread each, where the suite's
    parallel workers would otherwise oversubscribe the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def check_transformer_cli(module, extra, metric, tmp_path):
    jmain = importlib.import_module(
        f"feta_tmlr_tpu.experiments.{module}").main
    tmain = importlib.import_module(
        f"feta_tmlr_tpu_torch.experiments.{module}").main
    got = _run_pair(jmain, tmain, GCKN + extra, tmp_path)
    assert sorted(got["test"]) == [metric]


@pytest.mark.parametrize("module,extra,metric", [
    ("run_transformer_gckn_gengcn", ["--gckn-path", "3"], "mae"),
    ("run_transformer_gckn_gengcn_cv",
     ["--datadir", FIXTURES, "--dataset", "TUFIX", "--gckn-agg",
      "--gckn-path", "2"], "acc"),
    ("run_transformer_gckn_gengcn_SBM_cv",
     ["--datadir", FIXTURES, "--dataset", "FIXTURE", "--gckn-path", "2"],
     "acc_sbm"),
    ("run_transformer_gckn_gengcn_molpcba", [], "ap"),
], ids=["zinc_gckn", "gengcn_cv", "gengcn_sbm", "molpcba"])
def test_gckn_transformer_cli_matches_jax_cli(module, extra, metric,
                                              tmp_path):
    check_transformer_cli(module, extra, metric, tmp_path)


def test_zinc_gckn_console_script():
    """`feta-torch-zinc-gckn` names the port's CLI."""
    import tomllib

    from feta_tmlr_tpu_torch.experiments import run_transformer_gckn_gengcn

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "pyproject.toml"), "rb") as f:
        scripts = tomllib.load(f)["project"]["scripts"]
    assert scripts["feta-torch-zinc-gckn"] == \
        f"{run_transformer_gckn_gengcn.__name__}:main"


def test_gckn_clis_refuse_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for module in ("run_transformer_gckn_gengcn", "gckn_sup"):
        main = importlib.import_module(
            f"feta_tmlr_tpu_torch.experiments.{module}").main
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main(["--epochs", "1"])
