"""The port's SBM and TU cross-validation trainers (`feta-torch-sbm`,
`feta-torch-tu-cv`) end to end on the CPU, against the JAX CLIs as in
tests/test_torch_cli.py (result keys, CSV columns, finite losses,
checkpoints, `--resume`), and on the repository's SBM and TU fixtures.
"""

import os

import numpy as np

from feta_tmlr_tpu_torch.experiments import (
    run_transformer_gengcn_cv as ttu)
from feta_tmlr_tpu_torch.experiments import (
    run_transformer_gengcn_SBM_cv as tsbm)
from test_torch_cli import _run_pair  # noqa: E402


def test_sbm_cli_matches_jax_cli(tmp_path):
    from feta_tmlr_tpu.experiments import run_transformer_gengcn_SBM_cv as j
    got = _run_pair(j.main, tsbm.main, ["--n-nodes", "24", "--lappe"],
                    tmp_path)
    assert "acc_sbm" in got["test"]


def test_tu_cv_cli_matches_jax_cli(tmp_path):
    from feta_tmlr_tpu.experiments import run_transformer_gengcn_cv as j
    got = _run_pair(j.main, ttu.main, ["--dataset", "MUTAG", "--lappe"],
                    tmp_path)
    assert "acc" in got["test"]


def test_fixture_runs_of_sbm_and_tu_cv(capsys):
    fixtures = os.path.join(os.path.dirname(__file__), "fixtures")
    common = ["--epochs", "1", "--device", "cpu", "--dim-hidden", "16",
              "--nb-layers", "1", "--nb-heads", "2", "--datadir", fixtures]
    res = tsbm.main(common + ["--dataset", "FIXTURE"])
    assert "loaded SBM_FIXTURE" in capsys.readouterr().out
    assert np.isfinite(res["history"][0]["loss"])
    res = ttu.main(common + ["--dataset", "TUFIX", "--batch-size", "4"])
    assert np.isfinite(res["history"][0]["loss"])
