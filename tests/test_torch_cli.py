"""The port's FeTA command-line trainers (`feta-torch-zinc`,
`feta-torch-molhiv`; the SBM and TU ones in tests/test_torch_cli_cv.py)
end to end on the CPU, against the JAX CLIs they
mirror (tests/test_cli_smoke.py): the same result keys, the same
`logs.csv` and `results.csv` columns, finite losses, a checkpoint per
epoch and a `--resume` run that continues from it. The JAX CLI runs one
epoch at a tiny width to give its columns; the port's runs two.
"""

import csv
import glob
import os

import numpy as np

from feta_tmlr_tpu_torch.experiments import run_transformer_gengcn as tzinc
from feta_tmlr_tpu_torch.experiments import (
    run_transformer_gengcn_molhiv as tmolhiv)

TINY = ["--synthetic-graphs", "20", "--dim-hidden", "16", "--nb-layers", "1",
        "--nb-heads", "2", "--batch-size", "8", "--datadir", "no-such-dir"]


def _columns(outdir, name):
    (path,) = glob.glob(os.path.join(outdir, "**", name), recursive=True)
    with open(path) as f:
        rows = list(csv.DictReader(f))
    return list(rows[0]), rows


def _run_pair(jmain, tmain, extra, tmp_path):
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    want = jmain(["--epochs", "1", "--outdir", jdir] + TINY + extra)
    ckpt = str(tmp_path / "ckpt")
    got = tmain(["--epochs", "2", "--outdir", tdir, "--ckpt-dir", ckpt,
                 "--device", "cpu"] + TINY + extra)
    assert sorted(got) == sorted(want)
    for name in ("logs.csv", "results.csv"):
        assert _columns(tdir, name)[0] == _columns(jdir, name)[0], name
    _, rows = _columns(tdir, "logs.csv")
    assert [int(r["epoch"]) for r in rows] == [0, 1]
    assert all(np.isfinite(float(r["loss"])) for r in rows)
    assert sorted(os.listdir(ckpt)) == ["0", "1", "fit_meta.json"]
    resumed = tmain(["--epochs", "3", "--ckpt-dir", ckpt, "--resume",
                     "--device", "cpu"] + TINY + extra)
    assert [r["epoch"] for r in resumed["history"]] == [2]
    assert np.isfinite(resumed["history"][0]["loss"])
    return got


def test_zinc_cli_matches_jax_cli(tmp_path):
    from feta_tmlr_tpu.experiments import run_transformer_gengcn as jzinc
    got = _run_pair(jzinc.main, tzinc.main,
                    ["--lappe", "--lap-dim", "4", "--pos-enc", "diffusion"],
                    tmp_path)
    assert np.isfinite(got["best_val"]) and "mae" in got["test"]


def test_molhiv_cli_matches_jax_cli(tmp_path):
    from feta_tmlr_tpu.experiments import (
        run_transformer_gengcn_molhiv as jmolhiv)
    got = _run_pair(jmolhiv.main, tmolhiv.main, [], tmp_path)
    assert "rocauc" in got["test"]


def test_molhiv_cli_reads_the_ogb_fixture(capsys):
    fixtures = os.path.join(os.path.dirname(__file__), "fixtures")
    res = tmolhiv.main(["--epochs", "1", "--device", "cpu",
                        "--dim-hidden", "16", "--nb-layers", "1",
                        "--nb-heads", "2", "--datadir", fixtures])
    assert "loaded ogbg-molhiv" in capsys.readouterr().out
    assert [r["epoch"] for r in res["history"]] == [0]


def test_zinc_cli_trains_on_the_zinc_fixture(capsys):
    fixtures = os.path.join(os.path.dirname(__file__), "fixtures")
    res = tzinc.main(["--epochs", "1", "--device", "cpu",
                      "--dim-hidden", "16", "--nb-layers", "2",
                      "--nb-heads", "2", "--lappe", "--lap-dim", "8",
                      "--datadir", fixtures])
    assert "loaded ZINC" in capsys.readouterr().out
    assert np.isfinite(res["history"][0]["loss"])
