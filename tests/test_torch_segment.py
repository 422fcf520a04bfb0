"""The port's segment primitives (`ops/segment.py`) and one-hot embedding
lookups (`nn/lookup.py`) on the CPU: outputs and gradients against the JAX
package's `ops/segment.py` (`jax.ops.segment_*`, autodiff) on the same
numpy inputs, within float32 rounding (rtol 1e-5, atol 1e-6; the sums run
in another order), and the lookups' table gradients against
`nn.Embedding`'s own backward. Their run-to-run bits on the card are
`tests/test_torch_cuda.py`'s.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from feta_tmlr_tpu.ops import segment as jseg
from feta_tmlr_tpu_torch.nn.lookup import Lookup, OneHotEmbedding
from feta_tmlr_tpu_torch.ops import segment as tseg

TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Many small torch ops: one intra-op thread each, where the suite's
    parallel workers would otherwise oversubscribe the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _inputs(seed, rows=40, segments=9, width=5, sort=False):
    """data [rows, width], ids in [0, segments) with segment 3 empty, a
    cotangent for the output."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, segments, rows)
    ids[ids == 3] = 4
    if sort:
        ids = np.sort(ids)
    data = rng.standard_normal((rows, width)).astype(np.float32)
    cot = rng.standard_normal((segments, width)).astype(np.float32)
    return data, ids.astype(np.int32), cot


def _jax_value_grad(fn, data, cot):
    out, vjp = jax.vjp(fn, jnp.asarray(data))
    return np.asarray(out), np.asarray(vjp(jnp.asarray(cot))[0])


def _torch_value_grad(fn, data, cot):
    x = torch.tensor(data, requires_grad=True)
    out = fn(x)
    out.backward(torch.from_numpy(cot))
    return out.detach().numpy(), x.grad.numpy()


@pytest.mark.parametrize("sort", [False, True], ids=["unsorted", "sorted"])
@pytest.mark.parametrize("op", ["segment_sum", "segment_max",
                                "segment_mean"])
def test_segment_reductions_match_jax(op, sort):
    data, ids, cot = _inputs(0, sort=sort)
    n = cot.shape[0]
    want, want_g = _jax_value_grad(
        lambda d: getattr(jseg, op)(d, jnp.asarray(ids), n), data, cot)
    got, got_g = _torch_value_grad(
        lambda d: getattr(tseg, op)(d, torch.from_numpy(ids), n,
                                    indices_are_sorted=sort), data, cot)
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got_g, want_g, **TOL)
    empty = 3
    assert got[empty].tolist() == want[empty].tolist()


def test_segment_softmax_and_coo_spmm_match_jax():
    rng = np.random.default_rng(1)
    e, v = 60, 12
    src = rng.integers(0, v, e).astype(np.int32)
    dst = rng.integers(0, v, e).astype(np.int32)
    dst[dst == 5] = 6                                  # node 5 gets no edge
    mask = rng.random(e) > 0.2
    logits = rng.standard_normal((e, 3)).astype(np.float32)
    cot = rng.standard_normal((e, 3)).astype(np.float32)
    want, want_g = _jax_value_grad(
        lambda l: jseg.segment_softmax(l, jnp.asarray(dst), v,
                                       jnp.asarray(mask)[:, None]),
        logits, cot)
    got, got_g = _torch_value_grad(
        lambda l: tseg.segment_softmax(l, torch.from_numpy(dst), v,
                                       torch.from_numpy(mask)[:, None]),
        logits, cot)
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got_g, want_g, **TOL)

    x = rng.standard_normal((v, 4)).astype(np.float32)
    w = rng.standard_normal(e).astype(np.float32)
    ycot = rng.standard_normal((v, 4)).astype(np.float32)
    ei = np.stack([src, dst])
    want, want_g = _jax_value_grad(
        lambda t: jseg.coo_spmm(jnp.asarray(ei), jnp.asarray(w), t, v,
                                jnp.asarray(mask)), x, ycot)
    got, got_g = _torch_value_grad(
        lambda t: tseg.coo_spmm(torch.from_numpy(ei), torch.from_numpy(w),
                                t, v, torch.from_numpy(mask)), x, ycot)
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got_g, want_g, **TOL)


def test_gather_rows_gradient_is_the_index_gradient():
    """gather_rows' backward (a segment sum) against `x[idx]`'s own
    (index_put with accumulation), on repeated indices of any shape."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((7, 3, 2)).astype(np.float32)
    idx = torch.from_numpy(rng.integers(0, 7, (11, 4)))
    cot = torch.from_numpy(rng.standard_normal((11, 4, 3, 2)).astype(
        np.float32))
    grads = []
    for fn in (tseg.gather_rows, lambda t, i: t[i]):
        t = torch.tensor(x, requires_grad=True)
        out = fn(t, idx)
        out.backward(cot)
        grads.append((out.detach(), t.grad))
    assert torch.equal(grads[0][0], grads[1][0])
    np.testing.assert_allclose(grads[0][1].numpy(), grads[1][1].numpy(),
                               **TOL)


def test_segment_lengths_from_sorted_ids():
    ids = torch.tensor([0, 0, 2, 2, 2, 5])
    assert tseg.segment_lengths(ids, 7).tolist() == [2, 0, 3, 0, 0, 1, 0]


@pytest.mark.parametrize("ids_dtype", [torch.int32, torch.int64])
def test_one_hot_embedding_gradient_matches_nn_embedding(ids_dtype):
    """OneHotEmbedding (the table of every `nn/san.py::embedding()` user)
    against `nn.Embedding`'s forward and backward on the same weights, at
    ~3,600 ids of a [B, N, N] bond-type layout."""
    g = torch.Generator().manual_seed(0)
    emb = OneHotEmbedding(5, 8)
    with torch.no_grad():
        emb.weight.normal_(generator=g)
    ids = torch.randint(0, 5, (4, 30, 30), generator=g, dtype=ids_dtype)
    cot = torch.randn(4, 30, 30, 8, generator=g)
    outs, grads = [], []
    for fn in (emb, lambda i: torch.nn.Embedding.forward(emb, i)):
        emb.zero_grad()
        out = fn(ids)
        out.backward(cot)
        outs.append(out.detach())
        grads.append(emb.weight.grad.clone())
    assert torch.equal(outs[0], outs[1])
    np.testing.assert_allclose(grads[0].numpy(), grads[1].numpy(),
                               rtol=1e-5, atol=1e-4)
    assert Lookup.apply(emb.weight, ids).shape == (4, 30, 30, 8)


def test_every_embedding_user_takes_the_one_hot_lookup():
    """The nets that build their tables with `nn/san.py::embedding()` (SAN,
    GAT, GatedGCN, the LSPE nets, SAN-LSPE, PNA) hold OneHotEmbedding
    tables under their old parameter names, and none holds a plain
    nn.Embedding."""
    from feta_tmlr_tpu_torch.nn.gat import GATNet
    from feta_tmlr_tpu_torch.nn.gatedgcn import GatedGCNLSPENet
    from feta_tmlr_tpu_torch.nn.lspe import GraphiTSpectraNet
    from feta_tmlr_tpu_torch.nn.pna import PNALSPENet
    from feta_tmlr_tpu_torch.nn.san import SANNet
    from feta_tmlr_tpu_torch.nn.san_lspe import SANLSPENet

    small = dict(device="cpu")
    nets = {
        "san": SANNet(num_atom_type=28, num_bond_type=4, hidden_dim=8,
                      out_dim=8, n_heads=2, n_layers=1, **small),
        "gat": GATNet(num_atom_type=28, hidden_dim=8, out_dim=8,
                      num_heads=2, n_layers=1, **small),
        "gatedgcn": GatedGCNLSPENet(num_atom_type=28, num_bond_type=4,
                                    hidden_dim=8, out_dim=8, n_layers=1,
                                    pos_enc_dim=4, **small),
        "graphit": GraphiTSpectraNet(num_atom_type=28, num_bond_type=4,
                                     hidden_dim=8, out_dim=8, n_heads=2,
                                     n_layers=1, pos_enc_dim=4, **small),
        "san_lspe": SANLSPENet(num_atom_type=28, num_bond_type=4,
                               hidden_dim=8, out_dim=8, n_heads=2,
                               n_layers=1, pos_enc_dim=4, **small),
        "pna": PNALSPENet(num_atom_type=28, num_bond_type=4, hidden_dim=8,
                          out_dim=8, n_layers=1, pos_enc_dim=4, towers=1,
                          edge_feat=True, edge_dim=4, **small),
    }
    for label, net in nets.items():
        tables = {n: type(m) for n, m in net.named_modules()
                  if isinstance(m, torch.nn.Embedding)}
        assert tables, label
        assert set(tables.values()) == {OneHotEmbedding}, (label, tables)
        names = dict(net.named_parameters())
        assert all(f"{n}.weight" in names for n in tables), label
