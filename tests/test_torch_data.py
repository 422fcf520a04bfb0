"""Port data path vs the JAX package: SBM generation, collation and host
PEs must be EXACTLY equal (same numpy/scipy calls on the same inputs)."""

import numpy as np
import pytest
import torch

from feta_tmlr_tpu.data import batch as jbatch
from feta_tmlr_tpu.data.synthetic import sbm_like_dataset as j_sbm
from feta_tmlr_tpu.pe import encodings as jpe
from feta_tmlr_tpu_torch.data import batch as tbatch
from feta_tmlr_tpu_torch.data.synthetic import sbm_like_dataset as t_sbm
from feta_tmlr_tpu_torch.pe import encodings as tpe


def _pair(seed=3, n_graphs=4, n_nodes=24):
    return (j_sbm(seed=seed, n_graphs=n_graphs, n_nodes=n_nodes),
            t_sbm(seed=seed, n_graphs=n_graphs, n_nodes=n_nodes))


def test_sbm_like_dataset_identical():
    jg, tg = _pair()
    assert len(jg) == len(tg)
    for a, b in zip(jg, tg):
        for f in ("x", "edge_index", "y", "degree"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


@pytest.mark.parametrize("norm", [None, "sym", "rw"])
def test_pe_identical(norm):
    jg, tg = _pair(seed=5, n_graphs=3, n_nodes=16)
    jpe.DiffusionEncoding(beta=0.7, normalization=norm).apply_to(jg)
    tpe.DiffusionEncoding(beta=0.7, normalization=norm).apply_to(tg)
    jpe.LapEncoding(4, normalization=norm).apply_to(jg)
    tpe.LapEncoding(4, normalization=norm).apply_to(tg)
    for a, b in zip(jg, tg):
        np.testing.assert_array_equal(a.pe, b.pe)
        np.testing.assert_array_equal(a.lap_pe, b.lap_pe)
        la = jpe.graph_laplacian(a.edge_index, a.num_nodes,
                                 normalization=norm).toarray()
        lb = tpe.graph_laplacian(b.edge_index, b.num_nodes,
                                 normalization=norm).toarray()
        np.testing.assert_array_equal(la, lb)


def test_lap_pe_pads_small_graphs_identically():
    jg, tg = _pair(seed=1, n_graphs=2, n_nodes=5)     # n < dim + 1
    jpe.LapEncoding(8).apply_to(jg)
    tpe.LapEncoding(8).apply_to(tg)
    for a, b in zip(jg, tg):
        assert b.lap_pe.shape == (b.num_nodes, 8)
        np.testing.assert_array_equal(a.lap_pe, b.lap_pe)


@pytest.mark.parametrize("max_nodes", [None, 32])
def test_collate_identical(max_nodes):
    jg, tg = _pair(seed=7)
    jpe.DiffusionEncoding(beta=1.0).apply_to(jg)
    tpe.DiffusionEncoding(beta=1.0).apply_to(tg)
    jpe.LapEncoding(4).apply_to(jg)
    tpe.LapEncoding(4).apply_to(tg)
    jb = jbatch.collate_graphs(jg, max_nodes=max_nodes, node_labels=True)
    tb = tbatch.collate_graphs(tg, max_nodes=max_nodes, node_labels=True)
    for f in ("x", "node_mask", "adj", "y", "pe", "lap_pe", "degree"):
        want, got = np.asarray(getattr(jb, f)), getattr(tb, f)
        assert isinstance(got, torch.Tensor)
        assert got.dtype == torch.from_numpy(want).dtype, f
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f)
    moved = tb.to("cpu")
    assert moved.max_nodes == tb.max_nodes and moved.num_graphs == 4


def test_collate_rejects_inconsistent_optional_fields():
    _, tg = _pair()
    tg[0].pe = np.ones((tg[0].num_nodes,) * 2, np.float32)
    with pytest.raises(ValueError, match="lack `pe`"):
        tbatch.collate_graphs(tg)
    with pytest.raises(ValueError, match="max_nodes"):
        tbatch.collate_graphs(tg[1:], max_nodes=4)


def test_pad_bucket_identical():
    for n in [1, 7, 8, 9, 48, 100, 512, 513, 1000, 1024, 1025]:
        assert tbatch.pad_bucket(n) == jbatch.pad_bucket(n)
