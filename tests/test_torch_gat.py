"""The port's GAT tier (GATNet, GATFeTANet and their layers) vs the JAX
package's `nn/gat.py`, on the CPU.

The graphs and the weights of tests/test_torch_san_family.py: three graphs
of 9, 7 and 6 nodes padded to 10, one with an isolated node (a
destination without in-edges: its softmax row is all masked and its
attention zero), weights drawn with numpy and copied across by
`convert.from_flax`. Outputs at rtol 5e-4 / atol 5e-5 and the gradients
of a fixed random projection of them with respect to every parameter at
rtol 1e-3 / atol 1e-5 (scaled by a tensor's largest entry past 1), in
eval mode and, with dropout 0, in train mode (batch norm on the masked
batch statistics, whose running statistics are held at rtol 1e-4 / atol
1e-5). Dropout is held to its seeding.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from feta_tmlr_tpu.nn import gat as jgat
from feta_tmlr_tpu_torch.convert import from_flax
from feta_tmlr_tpu_torch.nn import gat as tgat
from test_torch_san import _np
from test_torch_san_family import (
    MODEL_TOL,
    N_MAX,
    assert_grads_close,
    check_net,
    lpe_batches,
    random_variables,
)

STATS_TOL = dict(rtol=1e-4, atol=1e-5)
GAT = dict(num_atom_type=28, hidden_dim=4, out_dim=16, num_heads=4,
           n_layers=3)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """These tests run many small torch ops: one intra-op thread each,
    where the suite's parallel workers would otherwise oversubscribe the
    cores (the setting is restored after each test)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("net,opts", [
    ("GATNet", dict(readout="mean")),
    ("GATNet", dict(node_level=True, n_out=3, residual=False)),
    ("GATFeTANet", dict(readout="sum", filter_order=3)),
    ("GATFeTANet", dict(readout="max", batch_norm=False, dropout=0.1,
                        in_feat_dropout=0.1)),
], ids=["gat-mean", "gat-node-level", "feta-sum", "feta-max-no-bn"])
def test_gat_nets_match_jax(net, opts):
    """Eval mode (dropout inert); the last layer single-headed with the
    residual where out_dim == hidden_dim * num_heads."""
    kw = dict(GAT, **opts)
    jb, tb = lpe_batches()
    port = check_net(getattr(jgat, net)(**kw), getattr(tgat, net), kw, jb,
                     tb)
    assert [layer.gatconv.num_heads for layer in port.layers] == [4, 4, 1]
    assert all(hasattr(layer, "cheb_weight") == (net == "GATFeTANet")
               for layer in port.layers)


def test_gat_feta_train_mode_matches_jax():
    """Train mode at dropout 0: batch norm on the masked batch statistics;
    outputs, gradients and the updated running statistics."""
    kw = dict(GAT, filter_order=3)
    jb, tb = lpe_batches()
    jmodel = jgat.GATFeTANet(**kw)
    variables = random_variables(jmodel, jb, seed=4)
    w = np.random.default_rng(5).standard_normal((3, 1)).astype(np.float32)

    def loss(p):
        out, upd = jmodel.apply({**variables, "params": p}, jb, False,
                                mutable=["batch_stats"])
        return (out * jnp.asarray(w)).sum(), (out, upd)

    (_, (want, updated)), jgrads = jax.jit(jax.value_and_grad(
        loss, has_aux=True))(variables["params"])
    port = from_flax(variables, tgat.GATFeTANet(**kw, device="cpu"))
    got = port.train()(tb)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **MODEL_TOL)
    (got * torch.from_numpy(w)).sum().backward()
    ref = from_flax({"params": _np(jgrads),
                     "batch_stats": _np(updated["batch_stats"])},
                    tgat.GATFeTANet(**kw, device="cpu"))
    grads = dict(ref.named_parameters())
    for name, p in port.named_parameters():
        assert_grads_close(p.grad.numpy(), grads[name].detach().numpy(),
                           name)
    stats = dict(ref.named_buffers())
    for name, b in port.named_buffers():
        np.testing.assert_allclose(b.numpy(), stats[name].numpy(),
                                   err_msg=name, **STATS_TOL)


def test_dense_gat_conv_attention_matches_jax():
    """The attention itself: rows of real destinations sum to 1 over
    their in-edges, the isolated node's row and padded rows are 0."""
    jb, tb = lpe_batches()
    h = np.random.default_rng(6).standard_normal((3, N_MAX, 12)).astype(
        np.float32)
    jmod = jgat.DenseGATConv(out_dim=5, num_heads=3)
    args = (jnp.asarray(h), jnp.asarray(jb.adj), jnp.asarray(jb.node_mask))
    variables = random_variables(jmod, *args, seed=7)
    want_out, want_attn = jax.jit(jmod.apply)(variables, *args)
    port = from_flax(variables, tgat.DenseGATConv(12, 5, 3)).eval()
    out, attn = port(torch.from_numpy(h), tb.adj, tb.node_mask)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out),
                               **MODEL_TOL)
    np.testing.assert_allclose(attn.detach().numpy(), np.asarray(want_attn),
                               **MODEL_TOL)
    rows = attn.sum(-1)
    has_in = (tb.adj.sum(1) > 0) & tb.node_mask          # [B, N(dst)]
    assert int((~has_in & tb.node_mask).sum()) == 1      # the isolated node
    assert torch.allclose(rows.permute(0, 2, 1)[has_in],
                          torch.tensor(1.0), atol=1e-6)
    assert torch.all(rows.permute(0, 2, 1)[~has_in] == 0)


def test_gat_dropout_is_seeded_and_train_only():
    """Feature, attention and input dropout 0.2 from the model's
    generator: one seed one output, eval draws nothing."""
    _, tb = lpe_batches()
    model = tgat.GATFeTANet(**dict(GAT, dropout=0.2, in_feat_dropout=0.2),
                            device="cpu").train()
    runs = []
    for seed in (5, 5, 6):
        model.dropout_generator.manual_seed(seed)
        runs.append(model(tb).detach())
    assert torch.equal(runs[0], runs[1])
    assert not torch.equal(runs[0], runs[2])
    model.eval()
    state = model.dropout_generator.get_state()
    assert torch.equal(model(tb), model(tb))
    assert torch.equal(model.dropout_generator.get_state(), state)
