"""The port's COO collation, `ops/sparse_agg.py`, GatedGCN-LSPE and
PNA-LSPE (`nn/gatedgcn.py`, `nn/pna.py`) vs the JAX package, on the CPU.

The graphs and weights are tests/test_torch_lspe.py's (three graphs padded
to 10 with the random-walk PE; weights drawn with numpy and copied by
`convert.from_flax`), held at its tolerances: outputs rtol 5e-4 / atol
5e-5, gradients of every parameter rtol 1e-3 / atol 1e-5 (scaled past 1),
in eval mode and in train mode at dropout 0 (batch statistics, and their
running updates). The COO collation and the one-hot helpers are held
exactly. This file mirrors the JAX package's tests/test_gatedgcn_sparse.py,
test_pna_sparse.py and test_parity_{gatedgcn,pna}.py: the sparse mode
against the dense one, the stacked towers against the tower loop, the GRU,
the lapeig loss.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from feta_tmlr_tpu.data import batch as jbatch
from feta_tmlr_tpu.nn import gatedgcn as jgg
from feta_tmlr_tpu.nn import pna as jpna
from feta_tmlr_tpu.ops import sparse_agg as jsa
from feta_tmlr_tpu_torch.data import batch as tbatch
from feta_tmlr_tpu_torch.nn import gatedgcn as tgg
from feta_tmlr_tpu_torch.nn import pna as tpna
from feta_tmlr_tpu_torch.ops import sparse_agg as tsa
from test_torch_lspe import BASE, check_model, lspe_batches
from test_torch_san_family import MODEL_TOL, lpe_graphs

GG = {k: v for k, v in BASE.items() if k != "n_heads"}
PNA = dict(GG, towers=2, avg_d_log=1.3)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """These tests run many small torch ops: one intra-op thread each,
    where the suite's parallel workers would otherwise oversubscribe the
    cores (the setting is restored after each test)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# ------------------------------------------------------- COO collation

@pytest.mark.parametrize("edge_buckets", [None, (8, 64)])
def test_collate_with_coo_equals_jax(edge_buckets):
    """edge_index, edge_mask, edge_attr (float32 of int bond features),
    in_edges and in_edge_mask array for array; the dense fields as
    without COO; a batch without COO carries none of them."""
    jg, tg = lpe_graphs(jbatch), lpe_graphs(tbatch)
    rng = np.random.default_rng(2)
    for a, b in zip(jg, tg):
        a.edge_attr = b.edge_attr = rng.integers(
            0, 4, (a.num_edges, 3)).astype(np.int32)
    jb = jbatch.collate_graphs(jg, max_nodes=12, with_coo=True,
                               edge_buckets=edge_buckets)
    tb = tbatch.collate_graphs(tg, max_nodes=12, with_coo=True,
                               edge_buckets=edge_buckets)
    for name in ("edge_index", "edge_mask", "edge_attr", "in_edges",
                 "in_edge_mask", "adj", "x", "node_mask", "edge_type"):
        want, got = np.asarray(getattr(jb, name)), getattr(tb, name).numpy()
        assert got.dtype == want.dtype and np.array_equal(got, want), name
    assert tb.edge_index.shape[-1] == (64 if edge_buckets else 24)
    plain = tbatch.collate_graphs(tg, max_nodes=12)
    assert plain.edge_index is None and plain.in_edges is None


# -------------------------------------------------------------- one-hots

def test_sparse_agg_equals_jax():
    """Every helper of ops/sparse_agg.py on the same COO batch and random
    messages: the one-hots, gathers, segment sums, in-degrees, the
    incidence values and their max / min (0 on the isolated node), the
    dense-field lookup and the legacy gather / one-hot / segment sum."""
    jb, tb = lspe_batches(with_coo=True)
    je = jsa.make_sparse_edges(jb, with_incidence=True)
    te = tsa.make_sparse_edges(tb, with_incidence=True)
    for name in ("oh_src", "oh_dst", "inc_oh", "deg"):
        assert np.array_equal(getattr(te, name).numpy(),
                              np.asarray(getattr(je, name))), name
    rng = np.random.default_rng(3)
    x = rng.standard_normal((3, 10, 5)).astype(np.float32)
    msg = rng.standard_normal((3, tb.edge_index.shape[-1], 4)).astype(
        np.float32)
    jx, tx, jm, tm = jnp.asarray(x), torch.from_numpy(x), \
        jnp.asarray(msg), torch.from_numpy(msg)
    pairs = [
        (te.gather_src(tx), je.gather_src(jx)),
        (te.gather_dst(tx), je.gather_dst(jx)),
        (te.segment_sum(tm), je.segment_sum(jm)),
        (tsa.incidence_values(tm, te), jsa.incidence_values(jm, je)),
        (tsa.incidence_max(tm, te), jsa.incidence_max(jm, je)),
        (tsa.incidence_min(tm, te), jsa.incidence_min(jm, je)),
        (tsa.edge_gather(tx, te.src), jsa.edge_gather(jx, je.src)),
        (tsa.edge_segment_sum(tm, tsa.dst_onehot(te.dst, te.edge_mask, 10)),
         jsa.edge_segment_sum(jm, jsa.dst_onehot(je.dst, je.edge_mask, 10))),
        (tsa.edge_ids_from_dense(tb.edge_type, te.src, te.dst),
         jsa.edge_ids_from_dense(jnp.asarray(jb.edge_type), je.src, je.dst)),
    ]
    for i, (got, want) in enumerate(pairs):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-6, err_msg=str(i))
    iso = tsa.incidence_max(tm, te)[1, 6]       # the isolated node
    assert torch.all(iso == 0)
    with pytest.raises(ValueError, match="in_edges"):
        tsa.make_sparse_edges(dataclasses.replace(tb, in_edges=None),
                              with_incidence=True)


# -------------------------------------------------------------- GatedGCN

@pytest.mark.parametrize("coo,train,opts", [
    (False, False, dict(readout="sum")),
    (True, False, dict(readout="max")),
    (False, True, dict()),
    (True, True, dict(out_dim=12)),
    (False, False, dict(pe_init="lap_pe", residual=False)),
    (True, False, dict(pe_init="no_pe", batch_norm=False)),
    (False, False, dict(use_lapeig_loss=True, alpha_loss=0.5,
                        lambda_loss=0.1)),
    (True, True, dict(use_lapeig_loss=True, alpha_loss=0.5)),
], ids=["dense", "sparse", "dense-train", "sparse-train-narrow",
        "lap-pe-no-residual", "sparse-no-pe-no-bn", "lapeig-dense",
        "lapeig-sparse-train"])
def test_gatedgcn_matches_jax(coo, train, opts):
    """GatedGCNLSPENet on the dense mailbox and (a batch with COO edges:
    chosen automatically) the sparse mode, in eval and train mode; the
    LapPE variant (PE added to h, p zero), no PE, no batch norm; with the
    lapeig loss the pre-weighted term and its gradients."""
    kw = dict(GG, **opts)
    if kw.get("pe_init") == "lap_pe":
        kw["pos_enc_dim"] = BASE["pos_enc_dim"]
    jb, tb = lspe_batches(with_coo=coo)
    check_model(jgg.GatedGCNLSPENet(**kw), tgg.GatedGCNLSPENet, kw, jb, tb,
                train=train)


def test_gatedgcn_sparse_equals_dense():
    """One set of weights: the sparse mode's logits, per-node outputs and
    gradients equal the dense mode's (sums over the same terms in another
    order); `sparse_edges=False` forces the dense mode on a COO batch."""
    _, tb = lspe_batches(with_coo=True)
    dense = tgg.GatedGCNLSPENet(**GG, device="cpu").train()
    sparse = tgg.GatedGCNLSPENet(**GG, device="cpu").train()
    sparse.load_state_dict(dense.state_dict())
    tb_dense = tbatch.collate_graphs(lpe_graphs(tbatch), max_nodes=10)
    tb_dense.lap_pe = tb.lap_pe
    out_d, out_s = dense(tb_dense), sparse(tb)
    np.testing.assert_allclose(out_s.detach().numpy(),
                               out_d.detach().numpy(), **MODEL_TOL)
    out_d.sum().backward()
    out_s.sum().backward()
    for (name, pd), (_, ps) in zip(dense.named_parameters(),
                                   sparse.named_parameters()):
        if pd.grad is not None:
            np.testing.assert_allclose(ps.grad.numpy(), pd.grad.numpy(),
                                       rtol=1e-3, atol=1e-5, err_msg=name)
    forced = tgg.GatedGCNLSPENet(**GG, sparse_edges=False, device="cpu")
    forced.load_state_dict(dense.state_dict())
    forced.eval()
    dense.eval()
    assert torch.equal(forced(tb), dense(tb_dense))


def test_lapeig_loss_equals_jax():
    jb, tb = lspe_batches()
    p = np.random.default_rng(4).standard_normal((3, 10, 5)).astype(
        np.float32)
    want = jgg.lapeig_loss(jnp.asarray(p), jnp.asarray(jb.adj),
                           jnp.asarray(jb.node_mask), 5, 0.3)
    got = tgg.lapeig_loss(torch.from_numpy(p), tb.adj, tb.node_mask, 5, 0.3)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


# ------------------------------------------------------------------ PNA

@pytest.mark.parametrize("coo,train,opts", [
    (False, False, dict(edge_feat=True, edge_dim=6)),
    (True, False, dict(edge_feat=True, edge_dim=6, sparse_edges=True)),
    (False, True, dict(edge_feat=True, gru=True)),
    (True, True, dict(sparse_edges=True, gru=True, pretrans_layers=2,
                      posttrans_layers=2)),
    (False, False, dict(vmap_towers=False, edge_feat=True, edge_dim=6)),
    (True, True, dict(vmap_towers=False, sparse_edges=True,
                      aggregators=("sum", "var", "max"),
                      scalers=("identity", "attenuation"))),
    (False, False, dict(towers=1, aggregators=("mean", "sum", "max"),
                        scalers=("identity",), readout="sum")),
    (False, True, dict(pe_init="no_pe", graph_norm=False, out_dim=12,
                       pretrans_layers=3)),
], ids=["dense", "sparse", "dense-train-gru", "sparse-train-gru-mlp2",
        "tower-loop", "tower-loop-sparse-train-aggs", "one-tower",
        "no-pe-train-narrow-pretrans3"])
def test_pna_matches_jax(coo, train, opts):
    """PNALSPENet: the dense and the sparse mode, the towers stacked (one
    batched product over T, flax's vmap layout) and in a loop, the GRU
    between layers, bond features at their own width, pre- and
    post-transforms of 2 and 3 layers, each aggregator and scaler."""
    kw = dict(PNA, **opts)
    jb, tb = lspe_batches(with_coo=coo)
    port = check_model(jpna.PNALSPENet(**kw), tpna.PNALSPENet, kw, jb, tb,
                       train=train)
    stacked = kw.get("vmap_towers", True) and kw["towers"] > 1
    assert hasattr(port.layers[0], "tower_0") != stacked
    if stacked:
        assert port.layers[0].towers.pretrans_h.fc_out.kernel.shape[0] == \
            kw["towers"]


def test_pna_stacked_towers_equal_the_tower_loop():
    """The stacked towers' tower t, copied into `tower_<t>` of the loop,
    gives the same outputs and gradients (dense and sparse)."""
    _, tb = lspe_batches(with_coo=True)
    for sparse in (False, True):
        kw = dict(PNA, towers=3, edge_feat=True, sparse_edges=sparse,
                  hidden_dim=18, out_dim=18)
        stacked = tpna.PNALSPENet(**kw, device="cpu").train()
        loop = tpna.PNALSPENet(**kw, vmap_towers=False, device="cpu").train()
        state = {}
        for k, v in stacked.state_dict().items():
            if ".towers." in k:
                for t in range(3):
                    state[k.replace(".towers.", f".tower_{t}.")] = v[t]
            else:
                state[k] = v
        loop.load_state_dict(state)
        out_s, out_l = stacked(tb), loop(tb)
        np.testing.assert_allclose(out_l.detach().numpy(),
                                   out_s.detach().numpy(), **MODEL_TOL)
        out_s.sum().backward()
        out_l.sum().backward()
        g = stacked.layers[1].towers.posttrans_h.fc_out.kernel.grad
        for t in range(3):
            got = getattr(loop.layers[1], f"tower_{t}").posttrans_h.fc_out
            np.testing.assert_allclose(got.kernel.grad.numpy(),
                                       g[t].numpy(), rtol=1e-3, atol=1e-5)


def test_pna_sparse_needs_coo_and_names_from_configs():
    _, tb = lspe_batches()
    with pytest.raises(ValueError, match="with_coo=True"):
        tpna.PNALSPENet(**PNA, sparse_edges=True, device="cpu")(tb)
    net = tpna.PNALSPENet(**dict(PNA, aggregators="mean sum max",
                                 scalers="identity"), device="cpu")
    assert net.layers[0].towers.aggregators == ("mean", "sum", "max")
    assert net.layers[0].towers.scalers == ("identity",)


def test_average_log_degree_equals_jax():
    jg, tg = lpe_graphs(jbatch), lpe_graphs(tbatch)
    assert tpna.average_log_degree(tg) == jpna.average_log_degree(jg)
    assert tpna.average_log_degree([]) == 1.0
