"""Packed batches in the port (`data/pack.py`, `nn/packed.py`,
`ops/cheb.py::cheb_filter_dynamic_per_node`, the pair-masked chain of
`ops/attention.py`, the trainer's packed losses and evaluation) vs the JAX
package, on the CPU.

The graphs: `random_graph_dataset(seed=21)`, 10 or 12 graphs of 5-14 nodes
with 7 float features, the degree feature, the diffusion kernel (beta 1)
and 4 Laplacian-PE columns, computed once by the port and handed to both
packages, packed into rows of 32 nodes. Tolerances: `pack_graphs` bit for
bit; the ops (float32, the same operations in another order) rtol 1e-5 /
atol 1e-6, their gradients the same; the packed model's eval logits and
regularizer within 1e-4 (rtol and atol) of JAX's and of the port's
unpacked model on the same weights; a Trainer step's loss within rtol
1e-5 and each gradient within 1e-2 of that tensor's largest entry (the
tolerances of a step in PERF.md §2: batch norm's statistics, over the same
real nodes packed or not, differ only by summation order), an entry of at
least 1e-5: the biases just before a batch norm get a gradient of 0 by
construction, |g| ~ 1e-8 of rounding on either side.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from feta_tmlr_tpu.data import batch as jbatch
from feta_tmlr_tpu.data import pack as jpack
from feta_tmlr_tpu.nn import packed as jpacked
from feta_tmlr_tpu.ops import attention as jattn
from feta_tmlr_tpu.ops import cheb as jcheb
from feta_tmlr_tpu.train.trainer import TrainConfig as JTrainConfig
from feta_tmlr_tpu.train.trainer import Trainer as JTrainer
from feta_tmlr_tpu_torch.convert import from_flax
from feta_tmlr_tpu_torch.data.batch import Graph, collate_graphs
from feta_tmlr_tpu_torch.data.pack import pack_graphs, pack_rows
from feta_tmlr_tpu_torch.data.synthetic import random_graph_dataset
from feta_tmlr_tpu_torch.nn import packed as tpacked
from feta_tmlr_tpu_torch.nn.models import DiffGraphTransformerGenGCN
from feta_tmlr_tpu_torch.ops import attention as tattn
from feta_tmlr_tpu_torch.ops import cheb as tcheb
from feta_tmlr_tpu_torch.pe.encodings import DiffusionEncoding, LapEncoding
from feta_tmlr_tpu_torch.train.trainer import TrainConfig, Trainer
from test_torch_san import _np
from test_torch_san_family import random_variables

OPS_TOL = dict(rtol=1e-5, atol=1e-6)
LOGITS_TOL = dict(rtol=1e-4, atol=1e-4)
STEP_LOSS_RTOL = 1e-5
STEP_GRAD_REL = 1e-2
GRAD_FLOOR = 1e-5       # the largest |g| a tensor is scaled by at least
ROW = 32
KW = dict(in_size=7, nb_class=1, d_model=32, nb_heads=4,
          dim_feedforward=64, dropout=0.0, nb_layers=2, batch_norm=True,
          lap_pos_enc=True, lap_pos_enc_dim=4, filter_order=2)
FIELDS = ("x", "node_mask", "adj", "y", "pe", "lap_pe", "degree",
          "graph_id", "graph_mask")


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Many small torch ops: one intra-op thread each, where the suite's
    parallel workers would otherwise oversubscribe the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def port_graphs(n=10, seed=21):
    graphs = random_graph_dataset(seed=seed, n_graphs=n, min_nodes=5,
                                  max_nodes=14, n_features=7)
    for g in graphs:
        g.compute_degree_feature()
        g.y = np.float32(g.num_nodes / 10.0 - 1.0)   # a regression target
    DiffusionEncoding(beta=1.0).apply_to(graphs)
    LapEncoding(4).apply_to(graphs)
    return graphs


def jax_graphs(graphs):
    """The same arrays as JAX package graphs."""
    return [jbatch.Graph(x=g.x, edge_index=g.edge_index, y=g.y, pe=g.pe,
                         lap_pe=g.lap_pe, degree=g.degree) for g in graphs]


def int_graphs():
    """Integer atom ids of one column, no PE, a label vector of 3 tasks."""
    rng = np.random.default_rng(5)
    out = []
    for g in port_graphs(12, seed=4):
        out.append(Graph(x=rng.integers(0, 9, (g.num_nodes, 1)).astype(
            np.int32), edge_index=g.edge_index,
            y=rng.integers(0, 2, 3).astype(np.float32)))
    return out


@pytest.mark.parametrize("kind", ["float", "int"])
def test_pack_graphs_bit_equal_to_jax(kind):
    graphs = port_graphs() if kind == "float" else int_graphs()
    want = jpack.pack_graphs(jax_graphs(graphs), row_len=ROW)
    got = pack_graphs(graphs, row_len=ROW)
    for name in FIELDS:
        w, g = getattr(want, name), getattr(got, name)
        if w is None:
            assert g is None, name
            continue
        g = g.numpy()
        assert g.dtype == np.asarray(w).dtype, name
        np.testing.assert_array_equal(g, np.asarray(w), err_msg=name)
    assert got.x.shape[0] < len(graphs)
    rows = pack_rows([g.num_nodes for g in graphs], ROW)
    assert sorted(sum(rows, [])) == list(range(len(graphs)))
    for r, members in enumerate(rows):
        for slot, gi in enumerate(members):
            assert int((got.graph_id[r] == slot).sum()) \
                == graphs[gi].num_nodes


def test_pack_graphs_refusals():
    graphs = port_graphs()
    with pytest.raises(ValueError, match="exceeds row_len"):
        pack_graphs(graphs, row_len=8)
    g = graphs[0]
    g.y = np.zeros(g.num_nodes, np.int64)
    with pytest.raises(NotImplementedError, match="graph-level labels"):
        pack_graphs([g], row_len=ROW)


def _vjp_check(jfn, tfn, args, seed):
    """Outputs and the gradients of sum(out * w) with respect to every
    argument, JAX against the port."""
    jout, vjp = jax.vjp(jfn, *[jnp.asarray(a) for a in args])
    w = np.random.default_rng(seed).standard_normal(
        np.shape(jout)).astype(np.float32)
    jgrads = vjp(jnp.asarray(w))
    targs = [torch.tensor(a, requires_grad=True) for a in args]
    tout = tfn(*targs)
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout),
                               **OPS_TOL)
    (tout * torch.from_numpy(w)).sum().backward()
    for i, (t, jg) in enumerate(zip(targs, jgrads)):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(jg),
                                   err_msg=f"argument {i}", **OPS_TOL)


def test_cheb_filter_dynamic_per_node_matches_jax():
    """N = 70 > NODE_BLOCK: the Laplacian products take the blocked path."""
    rng = np.random.default_rng(0)
    b, h, n, k, d = 2, 2, 70, 3, 4
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    adj = (rng.random((b, n, n)) < 0.1).astype(np.float32)
    lhat = (0.5 * (adj + adj.transpose(0, 2, 1)) / 4.0).astype(np.float32)
    args = (f(b, h, n, d), lhat, 0.3 * f(b, h, n, k, d, d), f(d))
    _vjp_check(jcheb.cheb_filter_dynamic_per_node,
               tcheb.cheb_filter_dynamic_per_node, args, seed=1)


def test_pair_masked_chain_matches_jax():
    rng = np.random.default_rng(2)
    b, h, n = 2, 3, 12
    gid = np.repeat(np.arange(3), 4)[None].repeat(b, 0)
    mask = np.ones((b, n), bool)
    mask[1, 9:] = False
    pair = (gid[:, :, None] == gid[:, None, :]) & mask[:, :, None] \
        & mask[:, None, :]
    pe = (rng.random((b, n, n)) * pair).astype(np.float32)
    deg = (rng.random((b, n)) * mask).astype(np.float32)
    scores = rng.standard_normal((b, h, n, n)).astype(np.float32)
    v = rng.standard_normal((b, h, n, 5)).astype(np.float32)

    def jfn(s, vv):
        out, attn = jattn.modulated_attention_from_scores(
            s, vv, jnp.asarray(mask), pe=jnp.asarray(pe),
            degree=jnp.asarray(deg), pair_mask=jnp.asarray(pair))
        return jnp.concatenate([out, attn], -1)

    def tfn(s, vv):
        out, attn = tattn.modulated_attention_from_scores(
            s, vv, torch.from_numpy(mask), pe=torch.from_numpy(pe),
            degree=torch.from_numpy(deg), pair_mask=torch.from_numpy(pair))
        assert bool((attn[~torch.from_numpy(pair)[:, None]
                          .expand_as(attn)] == 0).all())
        return torch.cat([out, attn], -1)

    _vjp_check(jfn, tfn, (scores, v), seed=3)


@pytest.fixture(scope="module")
def packed_pair():
    """(port graphs, JAX packed batch, port packed batch, JAX model, its
    variables drawn by `random_variables`)."""
    graphs = port_graphs()
    jb = jpack.pack_graphs(jax_graphs(graphs), row_len=ROW)
    tb = pack_graphs(graphs, row_len=ROW)
    jmodel = jpacked.PackedDiffGraphTransformerGenGCN(**KW)
    return graphs, jb, tb, jmodel, random_variables(jmodel, jb, seed=6)


def port_packed(variables):
    return from_flax(variables, tpacked.PackedDiffGraphTransformerGenGCN(
        **KW, device="cpu"))


def test_packed_model_matches_jax(packed_pair):
    """Eval-mode logits [B, G, 1] and the regularizer through `from_flax`
    (the JAX packed model's flax tree is the unpacked one's)."""
    _, jb, tb, jmodel, variables = packed_pair
    jlogits, jreg = jax.jit(lambda v: jmodel.apply(
        v, jb, regularization=0.1))(variables)
    port = port_packed(variables).eval()
    with torch.no_grad():
        logits, reg = port(tb, regularization=0.1)
    assert logits.shape == (tb.x.shape[0], tb.graph_mask.shape[1], 1)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               **LOGITS_TOL)
    np.testing.assert_allclose(float(reg), float(jreg), **LOGITS_TOL)
    assert sorted(dict(port.named_parameters())) == sorted(dict(
        DiffGraphTransformerGenGCN(**KW, device="cpu").named_parameters()))


def _step_grads(model, batch, cfg):
    loss = Trainer(model, cfg).step(batch)
    return float(loss), {n: p.grad.numpy().copy()
                         for n, p in model.named_parameters()}


def _assert_step_close(got, want, label):
    (loss, grads), (wloss, wgrads) = got, want
    np.testing.assert_allclose(loss, wloss, rtol=STEP_LOSS_RTOL,
                               err_msg=label)
    for name, w in wgrads.items():
        scale = max(float(np.abs(w).max()), GRAD_FLOOR)
        err = float(np.abs(grads[name] - w).max()) / scale
        assert err <= STEP_GRAD_REL, f"{label}: {name} {err:.2e}"


def test_packed_trainer_step_matches_jax(packed_pair):
    """One `graph_reg` step (regularization 0.1, sign flip off, batch norm
    in train mode) of the port's Trainer against the JAX Trainer's loss and
    gradients, and the updated running statistics."""
    _, jb, tb, jmodel, variables = packed_pair
    cfg = dict(task="graph_reg", regularization=0.1, sign_flip=False)
    jtr = JTrainer(jmodel, JTrainConfig(**cfg))
    jloss, jgrads, jstats = jax.jit(jtr._loss_and_grads)(
        {"params": variables["params"]}, variables["batch_stats"], jb,
        jax.random.key(0))
    want = from_flax({"params": _np(jgrads["params"]),
                      "batch_stats": variables["batch_stats"]},
                     tpacked.PackedDiffGraphTransformerGenGCN(
                         **KW, device="cpu"))
    port = port_packed(variables)
    got = _step_grads(port, tb, TrainConfig(**cfg))
    _assert_step_close(got, (float(jloss), {
        n: p.detach().numpy() for n, p in want.named_parameters()}), "jax")
    stats = from_flax({"params": variables["params"],
                       "batch_stats": _np(jstats)},
                      tpacked.PackedDiffGraphTransformerGenGCN(
                          **KW, device="cpu"))
    got_b = dict(port.named_buffers())
    for name, buf in stats.named_buffers():
        np.testing.assert_allclose(got_b[name].numpy(), buf.numpy(),
                                   err_msg=name, **LOGITS_TOL)


def slot_logits(logits, graphs, row_len=ROW):
    """Packed logits [B, G, C] back in the graphs' order [n_graphs, C]."""
    out = np.zeros((len(graphs),) + tuple(logits.shape[2:]), np.float32)
    for r, members in enumerate(pack_rows([g.num_nodes for g in graphs],
                                          row_len)):
        for slot, gi in enumerate(members):
            out[gi] = logits[r, slot]
    return out


@pytest.mark.parametrize("last_layer_filter", [True, False],
                         ids=["last", "every"])
def test_packed_model_matches_unpacked(packed_pair, last_layer_filter):
    """The port's packed model against its own unpacked model on the same
    weights (same seed): eval logits in graph order, a Trainer step's loss
    and gradients, and `Trainer.evaluate` (packed slots flattened) against
    the unpacked evaluation."""
    graphs = packed_pair[0]
    kw = dict(KW, last_layer_filter=last_layer_filter, seed=3)
    packed = tpacked.PackedDiffGraphTransformerGenGCN(**kw, device="cpu")
    plain = DiffGraphTransformerGenGCN(**kw, device="cpu")
    for (n, p), q in zip(packed.state_dict().items(),
                         plain.state_dict().values()):
        assert torch.equal(p, q), n
    pb, ub = packed_pair[2], collate_graphs(graphs, max_nodes=16)
    cfg = TrainConfig(task="graph_reg", regularization=0.1, sign_flip=False)
    with torch.no_grad():
        got = slot_logits(packed.eval()(pb, regularization=0.1)[0].numpy(),
                          graphs)
        want = plain.eval()(ub)[0].numpy()
    np.testing.assert_allclose(got, want, **LOGITS_TOL)
    assert Trainer(packed, cfg).evaluate([pb]) == pytest.approx(
        Trainer(plain, cfg).evaluate([ub]), rel=1e-5)
    _assert_step_close(_step_grads(packed, pb, cfg),
                       _step_grads(plain, ub, cfg), "unpacked")


def test_packed_encoder_refuses_other_laplacians_and_filters():
    with pytest.raises(NotImplementedError, match="'sym'"):
        tpacked.PackedFeTAEncoder(16, 2, 1, laplacian_norm="rw")
    with pytest.raises(NotImplementedError, match="dynamic Chebyshev"):
        tpacked.PackedFeTAEncoder(16, 2, 1, gnn_type="ARMAConvDynamic")


def test_packed_regularizer_gradient_finite_on_empty_slots():
    """A row with fewer graphs than G has empty slots, whose coefficients
    are 0: the regularizer's sqrt is guarded there, so its gradient stays
    finite."""
    graphs = port_graphs()
    tb = pack_graphs(graphs, row_len=ROW)
    assert not bool(tb.graph_mask.all())
    model = tpacked.PackedDiffGraphTransformerGenGCN(**KW, device="cpu")
    _, reg = model(tb, regularization=1.0)
    reg.backward()
    assert all(torch.isfinite(p.grad).all() for p in model.parameters()
               if p.grad is not None)
