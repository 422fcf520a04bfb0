"""The port's last two FeTA OGB CLIs, `feta-torch-molpcba` and
`feta-torch-pcqm4m`, end to end on the CPU against the JAX CLIs they
mirror (`run_transformer_gengcn_{molpcba,pcqm4m}`), with the same argv at
a tiny width: the same result keys, the same `logs.csv` and `results.csv`
columns, finite losses, a checkpoint per epoch and a `--resume` run that
continues from it (tests/test_torch_cli.py's `_run_pair`; the JAX CLI runs
one epoch, the port's two). Data: molpcba's synthetic fallback (128
tasks) and, for pcqm4m, the LSC SMILES layout of
tests/fixtures/pcqm4m_kddcup2021 through `data/smiles.py`; both synthetic
fallbacks also run on the port alone. The molpcba
fixture's atom ids run past OGB's vocabularies (NaN logits in both
packages), so it is not used here. The OGB atom encoder's table gradients,
one-hot products that make a resumed run bit-equal on the card
(`nn/ogb.py::_Lookup`), are held to `nn.Embedding`'s within rtol 1e-5 /
atol 1e-6 (float32, the same sums in another order: the ops tolerance of
tests/test_torch_feta_options.py).
"""

import os

import numpy as np
import pytest
import torch

from feta_tmlr_tpu_torch.data.ogb_raw import ATOM_FEATURE_DIMS
from feta_tmlr_tpu_torch.experiments import (
    run_transformer_gengcn_molpcba as tmolpcba,
    run_transformer_gengcn_pcqm4m as tpcqm4m,
)
from feta_tmlr_tpu_torch.nn.ogb import OGBAtomEncoder
from test_torch_cli import _run_pair

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Many small torch ops: one intra-op thread each, where the suite's
    parallel workers would otherwise oversubscribe the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("module,extra,metric", [
    ("run_transformer_gengcn_molpcba", [], "ap"),
    ("run_transformer_gengcn_pcqm4m", ["--datadir", FIXTURES], "mae"),
], ids=["molpcba", "pcqm4m-lsc"])
def test_ogb_cli_matches_jax_cli(module, extra, metric, tmp_path, capsys):
    import importlib
    jmain = importlib.import_module(
        f"feta_tmlr_tpu.experiments.{module}").main
    tmain = {"run_transformer_gengcn_molpcba": tmolpcba,
             "run_transformer_gengcn_pcqm4m": tpcqm4m}[module].main
    got = _run_pair(jmain, tmain, extra, tmp_path)
    assert sorted(got["test"]) == [metric]
    assert np.isfinite(got["best_val"])
    out = capsys.readouterr().out
    if extra:
        assert "loaded pcqm4m_kddcup2021 LSC smiles (8/2/2)" in out


def test_molpcba_and_pcqm4m_synthetic_fallbacks(capsys):
    """Without data: molpcba's 128 tasks read from the synthetic labels (a
    [128, d] head); pcqm4m on synthetic gap-like targets, a finite MAE."""
    tiny = ["--epochs", "1", "--device", "cpu", "--synthetic-graphs", "20",
            "--dim-hidden", "16", "--nb-layers", "1", "--nb-heads", "2",
            "--batch-size", "8", "--datadir", "no-such-dir"]
    res = tmolpcba.main(tiny)
    assert res["state"]["cls_fc2.weight"].shape == (tmolpcba.N_TASKS, 16)
    res = tpcqm4m.main(tiny)
    assert "synthetic" in capsys.readouterr().out
    assert np.isfinite(res["test"]["mae"])


def test_console_scripts_name_the_new_entry_points():
    import tomllib
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "pyproject.toml"), "rb") as f:
        scripts = tomllib.load(f)["project"]["scripts"]
    for name, mod in (("feta-torch-molpcba", tmolpcba),
                      ("feta-torch-pcqm4m", tpcqm4m)):
        assert scripts[name] == f"{mod.__name__}:main"


def test_atom_encoder_gradients_match_nn_embedding():
    """Ids in range, negative (from the end) and out of range (NaN rows,
    whose gradient is dropped as JAX drops it): outputs bit-equal and
    table gradients as `nn.Embedding`'s own backward gives them."""
    rng = np.random.default_rng(0)
    ids = np.stack([rng.integers(-v, v, 600) for v in ATOM_FEATURE_DIMS],
                   -1).reshape(20, 30, -1)
    ids[0, 0, 1] = ATOM_FEATURE_DIMS[1]                  # out of range
    x = torch.from_numpy(ids.astype(np.int32))
    enc = OGBAtomEncoder(16, generator=torch.Generator().manual_seed(1))
    out = enc(x)
    want, outside = None, None
    for name, vocab, col in zip(enc.names, enc.dims, x.long().unbind(-1)):
        bad = (col < -vocab) | (col >= vocab)
        e = getattr(enc, name)(torch.where(bad, 0, col % vocab))
        want = e if want is None else want + e
        outside = bad if outside is None else outside | bad
    want = want.masked_fill(outside[..., None], float("nan"))
    assert torch.equal(torch.isnan(out), torch.isnan(want))
    real = ~torch.isnan(want)
    assert torch.equal(out[real], want[real])
    w = torch.from_numpy(rng.standard_normal(out.shape).astype(np.float32))
    grads = []
    for o in (out, want):
        enc.zero_grad()
        torch.where(real, o * w, 0.0).sum().backward(retain_graph=True)
        grads.append([getattr(enc, n).weight.grad.clone()
                      for n in enc.names])
    for name, g, h in zip(enc.names, *grads):
        np.testing.assert_allclose(g.numpy(), h.numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=name)
