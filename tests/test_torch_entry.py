"""The port's entry-point layer vs the JAX package, on the CPU: readers,
PE encodings and the PE cache, batches, the config corpus, checkpoints and
exact resume, `debug_nan`, and the options the port refuses.

Data must be equal field for field (PE kernels rtol 1e-6: the port takes
the diffusion kernel with the dense expm, the JAX package with the sparse
one) and batches exactly equal. Resume is held bit for bit: a 2-epoch fit
followed by a 2-epoch resume must equal a 4-epoch fit in every logged
number, best_val / best_epoch, the plateau learning rate and every weight.
"""

import argparse
import dataclasses
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from feta_tmlr_tpu.data import synthetic as jsyn
from feta_tmlr_tpu.data import zinc as jzinc
from feta_tmlr_tpu.experiments import common as jcommon
from feta_tmlr_tpu.nn.san import SANNodeSpectra as JSANNodeSpectra
from feta_tmlr_tpu.pe import encodings as jpe
from feta_tmlr_tpu.pe.cache import PECache as JPECache
from feta_tmlr_tpu.utils import config as jconfig
from feta_tmlr_tpu_torch.data import synthetic as tsyn
from feta_tmlr_tpu_torch.data import zinc as tzinc
from feta_tmlr_tpu_torch.data.batch import collate_graphs
from feta_tmlr_tpu_torch.experiments import common as tcommon
from feta_tmlr_tpu_torch.experiments import main_ZINC_graph_regression as tmain
from feta_tmlr_tpu_torch.experiments import run_transformer_gengcn as tzinc_cli
from feta_tmlr_tpu_torch.experiments import serve_main as tserve_main
from feta_tmlr_tpu_torch.nn.models import DiffGraphTransformerGenGCN
from feta_tmlr_tpu_torch.nn.san import SANNodeSpectra
from feta_tmlr_tpu_torch.pe import encodings as tpe
from feta_tmlr_tpu_torch.pe.cache import PECache
from feta_tmlr_tpu_torch.pe.laplace import apply_laplace_decomp
from feta_tmlr_tpu_torch.train.checkpoint import CheckpointManager
from feta_tmlr_tpu_torch.train.trainer import (
    NonFiniteError,
    TrainConfig,
    Trainer,
    _check_finite,
)
from feta_tmlr_tpu_torch.utils import config as tconfig

ROOT = Path(__file__).resolve().parents[1]
FIXTURES = str(ROOT / "tests" / "fixtures")
CONFIGS = sorted(str(p.relative_to(ROOT)) for p in (ROOT / "configs").rglob("*")
                 if p.is_file() and p.name != "README.md")
GRAPH_FIELDS = ("x", "edge_index", "y", "pe", "lap_pe", "degree", "edge_type",
                "eigvecs", "eigvals", "edge_attr")
BATCH_FIELDS = ("x", "node_mask", "adj", "y", "pe", "lap_pe", "degree",
                "edge_type")
PE_TOL = dict(rtol=1e-6, atol=0)
SAN_CFG = dict(num_atom_type=28, num_bond_type=4, hidden_dim=16, out_dim=16,
               n_heads=2, n_layers=1, lpe_dim=4, lpe_heads=2, lpe_layers=1,
               filter_order=3)


def _same_graphs(a, b, pe_tol=None):
    assert len(a) == len(b)
    for ga, gb in zip(a, b):
        for f in GRAPH_FIELDS:
            va, vb = getattr(ga, f, None), getattr(gb, f, None)
            assert (va is None) == (vb is None), f
            if va is None:
                continue
            if f == "pe" and pe_tol is not None:
                np.testing.assert_allclose(vb, va, err_msg=f, **pe_tol)
            else:
                np.testing.assert_array_equal(np.asarray(vb), np.asarray(va),
                                              err_msg=f)
                assert np.asarray(vb).dtype == np.asarray(va).dtype, f


def _same_batches(jbs, tbs):
    assert len(jbs) == len(tbs)
    for jb, tb in zip(jbs, tbs):
        for f in BATCH_FIELDS:
            want, got = getattr(jb, f), getattr(tb, f)
            assert (want is None) == (got is None), f
            if want is not None:
                want = np.asarray(want)
                assert got.numpy().dtype == want.dtype, f
                np.testing.assert_array_equal(got.numpy(), want, err_msg=f)


# ------------------------------------------------------------- readers

@pytest.mark.parametrize("subset", [True, False])
def test_zinc_reader_matches_jax(subset):
    want = jzinc.load_zinc_or_synthetic(FIXTURES, subset=subset)
    got = tzinc.load_zinc_or_synthetic(FIXTURES, subset=subset)
    assert got[3] and want[3]
    assert tzinc.find_zinc_dir(FIXTURES) == jzinc.find_zinc_dir(FIXTURES)
    for a, b in zip(want[:3], got[:3]):
        _same_graphs(a, b)
    assert [len(s) for s in got[:3]] == ([6, 3, 3] if subset else [12, 5, 5])


def test_zinc_synthetic_fallback_matches_jax():
    want = jzinc.load_zinc_or_synthetic("no-such-dir", seed=3, n_synthetic=20)
    got = tzinc.load_zinc_or_synthetic("no-such-dir", seed=3, n_synthetic=20)
    assert not got[3]
    for a, b in zip(want[:3], got[:3]):
        _same_graphs(a, b)


def _args(**kw):
    base = dict(datadir=FIXTURES, seed=0, synthetic_graphs=20,
                max_graphs=None, pos_enc=None, lappe=False, lap_dim=4, p=2,
                beta=0.5, normalization="sym", zero_diag=False)
    base.update(kw)
    return argparse.Namespace(**base)


def test_ogb_tier_matches_jax():
    args = _args()
    want = jcommon.load_ogb_tier(args, "ogbg-molhiv", lambda: [])
    got = tcommon.load_ogb_tier(args, "ogbg-molhiv", lambda: [])
    assert got[3] and want[3]
    for a, b in zip(want[:3], got[:3]):
        _same_graphs(a, b)


@pytest.mark.parametrize("datadir", [FIXTURES, "no-such-dir"])
def test_sbm_tier_matches_jax(datadir):
    args = _args(datadir=datadir, dataset="FIXTURE", n_nodes=20,
                 synthetic_graphs=10)
    want = jcommon.load_sbm_tier(args)
    got = tcommon.load_sbm_tier(args)
    assert got[3:] == want[3:]
    assert got[5] == (datadir == FIXTURES)
    for a, b in zip(want[:3], got[:3]):
        _same_graphs(a, b)
    from feta_tmlr_tpu.data import sbm as jsbm
    from feta_tmlr_tpu_torch.data import sbm as tsbm
    assert tsbm.find_sbm_dir(FIXTURES, "SBM_FIXTURE") == \
        jsbm.find_sbm_dir(FIXTURES, "SBM_FIXTURE")


@pytest.mark.parametrize("datadir", [FIXTURES, "no-such-dir"])
def test_tu_tier_and_folds_match_jax(datadir, tmp_path):
    args = _args(datadir=datadir, dataset="TUFIX", synthetic_graphs=30)
    want = jcommon.load_tu_or_synthetic(args)
    got = tcommon.load_tu_or_synthetic(args)
    assert got[1:] == want[1:]
    _same_graphs(want[0], got[0])
    from feta_tmlr_tpu.data import tu as jtu
    from feta_tmlr_tpu_torch.data import tu as ttu
    graphs = got[0]
    for fold in (1, 2, 5):
        for a, b in zip(jtu.load_fold_indices(want[0], fold, seed=3),
                        ttu.load_fold_indices(graphs, fold, seed=3)):
            np.testing.assert_array_equal(a, b)
    # the reference's fold files win over the stratified split
    base = tmp_path / "TUFIX" / "10fold_idx"
    base.mkdir(parents=True)
    np.savetxt(base / "train_idx-1.txt", [0, 2, 3], fmt="%d")
    np.savetxt(base / "test_idx-1.txt", [1, 4], fmt="%d")
    tr, te = ttu.load_fold_indices(graphs, 1, name="TUFIX",
                                   fold_dir=str(tmp_path))
    assert tr.tolist() == [0, 2, 3] and te.tolist() == [1, 4]


@pytest.mark.parametrize("n,classes,folds", [(37, 2, 10), (100, 3, 5),
                                             (23, 4, 4), (188, 2, 10)])
def test_stratified_kfold_matches_scikit_learn(n, classes, folds):
    from sklearn.model_selection import StratifiedKFold
    from feta_tmlr_tpu_torch.data.tu import stratified_kfold
    y = np.random.default_rng(n).integers(0, classes, n) * 3 - 1
    for seed in (0, 1, 7):
        want = StratifiedKFold(folds, shuffle=True, random_state=seed).split(
            np.zeros(n), y)
        for (a_tr, a_te), (b_tr, b_te) in zip(want,
                                              stratified_kfold(y, folds, seed)):
            np.testing.assert_array_equal(a_tr, b_tr)
            np.testing.assert_array_equal(a_te, b_te)
    with pytest.raises(ValueError):
        stratified_kfold(np.array([0, 0, 1]), 10, 0)


def test_random_graph_dataset_identical():
    for kw in (dict(), dict(task="regression"), dict(node_level=True)):
        _same_graphs(jsyn.random_graph_dataset(seed=5, n_graphs=6, **kw),
                     tsyn.random_graph_dataset(seed=5, n_graphs=6, **kw))


# ------------------------------------------------------ encodings, batches

ENCODINGS = {
    "diffusion": dict(beta=0.7, normalization="sym"),
    "diffusion-zero-diag": dict(beta=1.0, normalization=None, zero_diag=True),
    "pstep": dict(p=3, beta=0.5, normalization="sym"),
    "pstep-rw": dict(p=2, beta=0.25, normalization="rw", zero_diag=True),
    "adj": dict(normalization="sym"),
}


@pytest.mark.parametrize("name", sorted(ENCODINGS))
def test_posencodings_match_jax(name):
    kind = name.split("-")[0]
    kw = ENCODINGS[name]
    jg = jsyn.zinc_categorical_dataset(seed=2, n_graphs=5)
    tg = tsyn.zinc_categorical_dataset(seed=2, n_graphs=5)
    jpe.POSENCODINGS[kind](**kw).apply_to(jg)
    tpe.POSENCODINGS[kind](**kw).apply_to(tg)
    for a, b in zip(jg, tg):
        assert b.pe.dtype == np.float32
        np.testing.assert_allclose(b.pe, a.pe, **PE_TOL)
    assert sorted(tpe.POSENCODINGS) == sorted(jpe.POSENCODINGS)


def test_full_encoding_and_edge_weights_match_jax():
    jg = jsyn.zinc_categorical_dataset(seed=4, n_graphs=3)
    tg = tsyn.zinc_categorical_dataset(seed=4, n_graphs=3)
    for g in jg + tg:
        g.edge_attr = (1.0 + g.edge_type).astype(np.float32)
    jpe.FullEncoding().apply_to(jg)
    tpe.FullEncoding().apply_to(tg)
    _same_graphs(jg, tg)
    # weighted edges: the Laplacian and the p-step kernel (sparse products
    # on both sides) are exactly equal
    jpe.PStepRWEncoding(p=3, beta=0.25, use_edge_attr=True).apply_to(jg)
    tpe.PStepRWEncoding(p=3, beta=0.25, use_edge_attr=True).apply_to(tg)
    for a, b in zip(jg, tg):
        np.testing.assert_array_equal(b.pe, a.pe)
        for norm in (None, "sym", "rw"):
            np.testing.assert_array_equal(
                tpe.graph_laplacian(b.edge_index, b.num_nodes, norm,
                                    b.edge_attr).toarray(),
                jpe.graph_laplacian(a.edge_index, a.num_nodes, a.edge_attr,
                                    norm).toarray())


def test_pe_cache_shared_with_jax(tmp_path):
    """Each package reads the other's cache file; a cached run gives the
    computed run's kernels."""
    tg = tsyn.zinc_categorical_dataset(seed=6, n_graphs=4)
    enc = tpe.PStepRWEncoding(p=2, cache=PECache(str(tmp_path)),
                              zero_diag=True)
    enc.apply_to(tg, split="train")
    key = enc.cache_key()
    jkey = jpe.PStepRWEncoding(p=2).cache_key()
    assert key == jkey
    jloaded = JPECache(str(tmp_path)).load(key, "train")
    tloaded = PECache(str(tmp_path)).load(key, "train")
    assert len(jloaded) == len(tloaded) == 4
    for a, b in zip(jloaded, tloaded):
        np.testing.assert_array_equal(a, b)
    again = tsyn.zinc_categorical_dataset(seed=6, n_graphs=4)
    tpe.PStepRWEncoding(p=2, cache=PECache(str(tmp_path)),
                        zero_diag=True).apply_to(again, split="train")
    for a, b in zip(tg, again):
        np.testing.assert_array_equal(a.pe, b.pe)
        assert (np.diag(b.pe) == 0).all()


@pytest.mark.parametrize("pos_enc,lappe", [("diffusion", True),
                                           ("pstep", False), ("adj", True)])
def test_make_batches_match_jax(pos_enc, lappe):
    args = _args(pos_enc=pos_enc, lappe=lappe, datadir="no-such-dir")
    jtr, _, _, jin, _ = jcommon.load_zinc_tier(args)
    ttr, _, _, tin, _ = tcommon.load_zinc_tier(args)
    assert jin == tin == 28
    jcommon.apply_position_encodings(jtr, args)
    tcommon.apply_position_encodings(ttr, args)
    _same_graphs(jtr, ttr, pe_tol=PE_TOL)
    for g in jtr:                  # batches of the same kernels
        g.pe = None
    for g in ttr:
        g.pe = None
    n = max(g.num_nodes for g in ttr)
    _same_batches(jcommon.make_batches(jtr, 5, n, shuffle_seed=3),
                  tcommon.make_batches(ttr, 5, n, shuffle_seed=3))
    _same_batches(jcommon.make_batches(jtr, 7), tcommon.make_batches(ttr, 7))


def test_onehot_and_outdir_match_jax(tmp_path):
    jg = jsyn.zinc_categorical_dataset(seed=1, n_graphs=3)
    tg = tsyn.zinc_categorical_dataset(seed=1, n_graphs=3)
    jcommon.onehot_x(jg, 28)
    tcommon.onehot_x(tg, 28)
    _same_graphs(jg, tg)
    ns = dict(outdir=str(tmp_path), lappe=True, lap_dim=8, batch_norm=True,
              dataset="ZINC", zero_diag=True, weight_decay=1e-4, dropout=0.0,
              lr=1e-3, nb_layers=2, nb_heads=2, dim_hidden=16,
              pos_enc="diffusion", normalization="sym", p=1, beta=1.0,
              fold_idx=1)
    assert tcommon.resolve_outdir(argparse.Namespace(**ns), "fam") == \
        jcommon.resolve_outdir(argparse.Namespace(**ns), "fam")


# ------------------------------------------------------------- configs

@pytest.mark.parametrize("path", CONFIGS)
def test_config_corpus_matches_jax(path):
    full = str(ROOT / path)
    cfg = tconfig.load_config(full, {"epochs": 3, "L": 2, "nothing": None})
    assert cfg == jconfig.load_config(full, {"epochs": 3, "L": 2,
                                             "nothing": None})
    got = tconfig.model_kwargs_for(SANNodeSpectra, cfg["net_params"])
    want = jconfig.model_kwargs_for(JSANNodeSpectra, cfg["net_params"])
    assert sorted(got) == sorted(want)
    assert got == want
    from feta_tmlr_tpu.experiments import main_ZINC_graph_regression as jmain
    for model_arg in (None, "SAN_NodeSpectra"):
        assert tmain.resolve_model_name(cfg, model_arg) == \
            jmain.resolve_model_name(cfg, model_arg)


def test_model_kwargs_for_reads_named_parameters_only():
    class Catchall(torch.nn.Module):
        def __init__(self, hidden_dim: int = 8, *args, **kwargs):
            super().__init__()

    got = tconfig.model_kwargs_for(Catchall, {"GT_hidden_dim": 4,
                                              "dropout": 0.1, "L": 3})
    assert got == {"hidden_dim": 4}
    assert tconfig.accepted_kwargs(SANNodeSpectra) >= {
        "hidden_dim", "readout", "full_graph", "last_layer_filter"}
    assert tcommon.set_accepted_defaults(
        SANNodeSpectra, {"n_layers": 2}, n_layers=5, gamma=0.5,
        bogus=1) == {"n_layers": 2, "gamma": 0.5}


def test_san_readouts_relate_as_defined():
    """sum / max / mean readouts of the same node features (each is held
    to the JAX model's in tests/test_torch_serve.py)."""
    graphs = tsyn.zinc_categorical_dataset(seed=0, n_graphs=3)
    apply_laplace_decomp(graphs, 6)
    batch = collate_graphs(graphs, max_nodes=32)
    outs = {}
    for readout in ("mean", "sum", "max"):
        m = SANNodeSpectra(**SAN_CFG, readout=readout, device="cpu").eval()
        feats = {}
        m.mlp_readout.register_forward_pre_hook(
            lambda mod, inp: feats.setdefault("hg", inp[0]))
        with torch.no_grad():
            m(batch)
        outs[readout] = feats["hg"]
    # the sum readout's features over the mean readout's are the node count
    counts = batch.node_mask.sum(1, keepdim=True).float()
    torch.testing.assert_close(outs["sum"], outs["mean"] * counts,
                               rtol=1e-5, atol=1e-5)
    assert (outs["max"] >= outs["mean"] - 1e-6).all()


# ----------------------------------------------------- checkpoints, resume

def _san_data(seed=0):
    graphs = tsyn.zinc_categorical_dataset(seed=seed, n_graphs=12)
    apply_laplace_decomp(graphs, 6)
    n = max(g.num_nodes for g in graphs)
    train = tcommon.make_batches(graphs[:8], 4, n, shuffle_seed=1)
    val = tcommon.make_batches(graphs[8:], 4, n)
    return train, val


def _san_trainer(**cfg):
    model = SANNodeSpectra(**SAN_CFG, seed=2, device="cpu")
    return Trainer(model, TrainConfig(
        task="graph_reg", lr=3e-2, weight_decay=1e-5, schedule="plateau",
        plateau_patience=0, plateau_factor=0.5, sign_flip=True, seed=5,
        **cfg))


def test_trainer_checkpoint_round_trip(tmp_path):
    train, _ = _san_data()
    trainer = _san_trainer()
    for b in train:
        trainer.step(b)
    mgr = CheckpointManager(str(tmp_path), max_to_keep=2)
    for step in (3, 4, 7):
        mgr.save(step, trainer.state_dict())
    assert mgr.all_steps() == [4, 7] and mgr.latest_step() == 7
    fresh = _san_trainer()
    fresh.load_state_dict(mgr.restore())
    for k, v in trainer.model.state_dict().items():
        assert torch.equal(fresh.model.state_dict()[k], v), k
    assert fresh.steps == trainer.steps == 2
    # the next step (sign flips, dropout seeds, Adam moments) is identical
    la, lb = trainer.step(train[0]), fresh.step(train[0])
    assert torch.equal(la, lb)
    for (k, p), q in zip(trainer.model.named_parameters(),
                         fresh.model.parameters()):
        assert torch.equal(p, q), k


def test_checkpoint_snapshots_at_save(tmp_path):
    train, _ = _san_data()
    trainer = _san_trainer()
    trainer.step(train[0])
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(0, trainer.state_dict())
    before = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    trainer.step(train[1])          # moves the weights after the save
    got = mgr.restore(0)["model"]
    assert all(torch.equal(got[k], v) for k, v in before.items())
    assert not all(torch.equal(got[k], v)
                   for k, v in trainer.model.state_dict().items())
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore()


@pytest.mark.parametrize("stop", [1, 2])
def test_fit_resume_is_bit_exact(tmp_path, stop):
    """`stop` epochs, then a resume to 4, against 4 epochs in one run."""
    train, val = _san_data()
    full = _san_trainer().fit(train, val, epochs=4)
    ckpt = str(tmp_path / "ckpt")
    first = _san_trainer()
    first.fit(train, val, epochs=stop, ckpt_dir=ckpt)
    meta = (tmp_path / "ckpt" / "fit_meta.json").read_text()
    assert '"best_epoch"' in meta and '"plateau_scale"' in meta
    second = _san_trainer()
    resumed = second.fit(train, val, epochs=4, ckpt_dir=ckpt, resume=True)
    strip = lambda rows: [{k: v for k, v in r.items() if k != "time"}
                          for r in rows]
    assert strip(resumed["history"]) == strip(full["history"])[stop:]
    assert [r["epoch"] for r in resumed["history"]] == list(range(stop, 4))
    assert resumed["best_val"] == full["best_val"]
    assert resumed["best_epoch"] == full["best_epoch"]
    lrs = [r["lr"] for r in full["history"]]
    assert len(set(lrs)) > 1, lrs         # the plateau schedule moved
    for k, v in full["state"].items():
        assert torch.equal(resumed["state"][k], v), k
    assert second.optimizer.param_groups[0]["lr"] == lrs[-1]


def test_fit_rebatch_fn_and_fresh_resume(tmp_path):
    train, val = _san_data()
    calls = []

    def rebatch(epoch):
        calls.append(epoch)
        return train[::-1]

    res = _san_trainer().fit(train, epochs=3, rebatch_fn=rebatch,
                             ckpt_dir=str(tmp_path / "empty"), resume=True)
    assert calls == [1, 2]
    assert [r["epoch"] for r in res["history"]] == [0, 1, 2]
    assert res["best_val"] is None


def test_debug_nan_raises_non_finite_error():
    train, _ = _san_data()
    trainer = _san_trainer(debug_nan=True)
    with torch.no_grad():
        trainer.model.embedding_h.weight[:] = float("nan")
    with pytest.raises(NonFiniteError, match="non-finite loss"):
        trainer.fit(train, epochs=1)
    model = SANNodeSpectra(**SAN_CFG, device="cpu")
    with torch.no_grad():
        model.mlp_readout.fc_out.bias[0] = 5000.0
    with pytest.raises(NonFiniteError, match=r"mlp_readout.fc_out.bias: "
                                             r"max\|p\|=5000"):
        _check_finite(model, 1.0, 3)
    _check_finite(SANNodeSpectra(**SAN_CFG, device="cpu"), 1.0, 0)


# ------------------------------------------------------------- refusals

PORTED = sorted(tmain.MODEL_REGISTRY)


def test_registry_names_match_jax():
    from feta_tmlr_tpu.experiments import main_ZINC_graph_regression as jmain
    assert sorted(tmain.MODEL_REGISTRY) == sorted(jmain.MODEL_REGISTRY)
    # every ZINC name is ported: none refuses
    assert all(isinstance(v, tuple) for v in tmain.MODEL_REGISTRY.values())
    for name in PORTED:
        tmain.resolve_build({"net_params": {}}, name)


@pytest.mark.parametrize("name", PORTED)
def test_ported_registry_names_resolve_like_jax(name):
    from feta_tmlr_tpu.experiments import main_ZINC_graph_regression as jmain
    cfg = {"net_params": {"GT_hidden_dim": 16, "LPE_dim": 4, "L": 2}}
    cls, kwargs = tmain.resolve_build(cfg, name)
    jcls, jkwargs = jmain.resolve_build(cfg, name)
    assert (cls.__name__, kwargs) == (jcls.__name__, jkwargs)


def test_zinc_cli_packed_matches_jax_cli(tmp_path):
    """feta-zinc --packed (once refused) on the ZINC fixture against the
    JAX CLI's packed branch with the same argv (tests/test_torch_cli.py's
    `_run_pair`: result keys, logs.csv and results.csv columns, finite
    losses, a checkpoint per epoch, a resumed epoch), its batches packed
    rows of 128 nodes."""
    from feta_tmlr_tpu.experiments import run_transformer_gengcn as jzinc
    from test_torch_cli import _run_pair
    got = _run_pair(jzinc.main, tzinc_cli.main,
                    ["--datadir", str(ROOT / "tests/fixtures"), "--lappe",
                     "--lap-dim", "4", "--pos-enc", "diffusion", "--packed"],
                    tmp_path)
    assert sorted(got["test"]) == ["mae"] and np.isfinite(got["best_val"])
    assert "encoder.coeff_head.gcn_kernel" in got["state"]


@pytest.mark.parametrize("flag", ["--wire", "--quantize"])
def test_serve_main_refuses_unported_options(flag):
    with pytest.raises(SystemExit, match=f"{flag}.*not ported.*ROADMAP"):
        tserve_main.main([flag, "--device", "cpu"])


def test_cli_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from feta_tmlr_tpu_torch.experiments import (
        run_transformer_gengcn_molpcba as tmolpcba,
        run_transformer_gengcn_pcqm4m as tpcqm4m)
    for main in (tzinc_cli.main, tmain.main, tserve_main.main,
                 tmolpcba.main, tpcqm4m.main):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main([])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tzinc_cli.main(["--packed"])
    from feta_tmlr_tpu_torch.experiments import (
        run_transformer_gengcn_molhiv as tmolhiv)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tmolhiv.main([])
    from feta_tmlr_tpu_torch.experiments import (
        main_molhiv_graph_classification as tmolhiv_config,
        main_SBMs_node_classification as tsbm_config)
    for main in (tsbm_config.main, tmolhiv_config.main):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main(["--model", "SAN"])
    from feta_tmlr_tpu_torch.nn.gat import GATFeTANet
    from feta_tmlr_tpu_torch.nn.san import SANNet
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SANNet(num_atom_type=4, num_bond_type=2, hidden_dim=8, out_dim=8,
               n_heads=2, n_layers=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        GATFeTANet(num_atom_type=4, hidden_dim=2, out_dim=4, num_heads=2,
                   n_layers=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tmain.construct_model(SANNodeSpectra, {})
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DiffGraphTransformerGenGCN(in_size=3, nb_class=1, d_model=8,
                                   nb_heads=2)


def test_entry_modules_exist_for_console_scripts():
    import tomllib
    scripts = tomllib.loads((ROOT / "pyproject.toml").read_text())[
        "project"]["scripts"]
    for name in ("feta-torch-zinc", "feta-torch-molhiv", "feta-torch-serve",
                 "feta-torch-sbm", "feta-torch-tu-cv"):
        module, func = scripts[name].split(":")
        assert module.startswith("feta_tmlr_tpu_torch.experiments.")
        mod = __import__(module, fromlist=[func])
        assert callable(getattr(mod, func))
        jname = name.replace("-torch", "")
        assert scripts[jname] == scripts[name].replace(
            "feta_tmlr_tpu_torch", "feta_tmlr_tpu")
    assert os.path.isfile(ROOT / "configs/LPE/ZINC/optimized.json")
    assert dataclasses.is_dataclass(TrainConfig)


def test_import_scan_covers_the_entry_point_subpackages():
    """tests/test_torch_model.py::test_port_never_imports_jax scans every
    module under the package: the entry points' subpackages included."""
    import ast
    files = sorted((ROOT / "feta_tmlr_tpu_torch").rglob("*.py"))
    for sub in ("experiments", "utils"):
        mine = [f for f in files if f.parent.name == sub]
        assert len(mine) >= 2, sub
        for path in mine:
            for node in ast.walk(ast.parse(path.read_text())):
                names = ([a.name for a in node.names]
                         if isinstance(node, ast.Import) else
                         [node.module or ""]
                         if isinstance(node, ast.ImportFrom) else [])
                for name in names:
                    assert name.split(".")[0] not in (
                        "jax", "flax", "feta_tmlr_tpu"), (path, name)
