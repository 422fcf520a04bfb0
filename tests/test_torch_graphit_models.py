"""The GraphiT baselines of the port (`nn/models.py`: GraphTransformer,
DiffGraphTransformer, DiffGraphTransformerGCN with `masked_max_pool`,
DiffGraphTransformerSBM, DiffGraphTransformerMolHiv) and its dense GNN
modules (`nn/gnn.py`: DenseGCNConv, DenseGINEPlus, DenseGENGCN) vs the JAX
package, on the CPU.

The graphs and the checks are tests/test_torch_feta_options.py's: three
graphs of 9, 7 and 6 nodes padded to 10 with float features (the molhiv
model: 9 integer OGB atom-feature columns), the degree feature, the
diffusion kernel and 4 Laplacian-PE columns; the same weights on both
sides; train-mode outputs and running statistics at rtol 5e-4 / atol
5e-5, every parameter's gradient (and, for the modules alone, the input's)
at rtol 1e-3 / atol 1e-5 times the tensor's largest entry past 1. The
vanilla GraphTransformer (no pe, no degree in the attention) is also held
to the JAX model on its Pallas flash and fused kernels, interpreted
(tests/test_torch_zinc.py's fixture `jax_route`). The TU config trainer's
eight nets, as its `resolve_build` and `construct_model` make them (float
features, no bond types), are held in eval mode to the JAX trainer's on
the first four TUFIX graphs.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from feta_tmlr_tpu.nn import gnn as jgnn
from feta_tmlr_tpu.nn import models as jmodels
from feta_tmlr_tpu_torch.data.ogb_raw import ATOM_FEATURE_DIMS
from feta_tmlr_tpu_torch.nn import gnn as tgnn
from feta_tmlr_tpu_torch.nn import models as tmodels
from test_torch_feta_options import (
    CFG,
    check_against_jax,
    graphit_batches,
)
from test_torch_san_family import N_MAX, assert_grads_close
from test_torch_zinc import jax_route  # noqa: F401 (fixture)

BASE = {k: v for k, v in CFG.items() if k != "filter_order"}
VANILLA = {k: v for k, v in BASE.items() if k != "batch_norm"}
MOLHIV = dict(d_model=16, nb_heads=2, dim_feedforward=32, dropout=0.0,
              nb_layers=2, batch_norm=True, lap_pos_enc=True,
              lap_pos_enc_dim=4)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Many small torch ops: one intra-op thread each, where the suite's
    parallel workers would otherwise oversubscribe the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def molhiv_batches():
    """`graphit_batches` with 9 integer atom-feature columns per node,
    each id inside its OGB vocabulary."""
    jb, tb = graphit_batches(seed=9)
    rng = np.random.default_rng(10)
    x = np.stack([rng.integers(0, d, tb.x.shape[:2])
                  for d in ATOM_FEATURE_DIMS], -1).astype(np.int32)
    return jb.replace(x=jnp.asarray(x)), tb.__class__(
        **{**tb.__dict__, "x": torch.from_numpy(x)})


@pytest.mark.parametrize("name,cfg", [
    ("GraphTransformer", VANILLA), ("DiffGraphTransformer", BASE),
    ("DiffGraphTransformerGCN", BASE), ("DiffGraphTransformerSBM", BASE),
])
def test_graphit_baseline_matches_jax(name, cfg):
    jb, tb = graphit_batches()
    port = check_against_jax(
        getattr(jmodels, name)(**cfg),
        lambda: getattr(tmodels, name)(**cfg, device="cpu"), jb, tb)
    assert sum(p.numel() for p in port.parameters()) > 0


def test_molhiv_baseline_matches_jax():
    """Logits, the (logits, 0.0, sigmoid) triple's regularizer slot, the
    gradients; the port's Trainer reads the triple as JAX's does."""
    from feta_tmlr_tpu_torch.train.trainer import TrainConfig, Trainer
    jb, tb = molhiv_batches()
    port = check_against_jax(
        jmodels.DiffGraphTransformerMolHiv(**MOLHIV),
        lambda: tmodels.DiffGraphTransformerMolHiv(**MOLHIV, device="cpu"),
        jb, tb)
    logits, reg, probs = port.eval()(tb)
    assert reg == 0.0
    torch.testing.assert_close(probs, torch.sigmoid(logits))
    tb.y = (tb.y > 0).float()
    loss = Trainer(port, TrainConfig(task="binary_graph", sign_flip=False,
                                     regularization=0.1)).step(tb)
    assert torch.isfinite(loss)


@pytest.mark.parametrize("jax_route", ["flash", "fused"], indirect=True)
def test_vanilla_transformer_matches_jax_on_the_pallas_route(jax_route):
    """GraphTransformer with no pe and no degree, the JAX model on the
    interpreted Pallas kernels (#1/#3/#4 or #10/#11 with both absent),
    the port on the same route's plain versions: eval-mode logits and
    every gradient."""
    jb, tb = graphit_batches(seed=6)
    check_against_jax(
        jmodels.GraphTransformer(**VANILLA),
        lambda: tmodels.GraphTransformer(**VANILLA, attention_impl=jax_route,
                                         device="cpu"),
        jb, tb, seed=3, train=False)


def test_masked_max_pool_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, N_MAX, 5)).astype(np.float32)
    x[1, :, 2] = 0.0                                     # ties
    mask = np.ones((3, N_MAX), bool)
    mask[0, 6:] = mask[2, 3:] = False
    g = rng.standard_normal((3, 5)).astype(np.float32)
    want, vjp = jax.vjp(lambda a: jmodels.masked_max_pool(a, mask), x)
    tx = torch.from_numpy(x).requires_grad_()
    got = tmodels.masked_max_pool(tx, torch.from_numpy(mask))
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    (got * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(vjp(g)[0]),
                               rtol=1e-6, atol=1e-7)


def _module_case(jmodule, tmodule, jb, tb, x, *extra):
    """A dense GNN module on x [B, N, D] over the batch's adjacency: its
    output, the gradients of its parameters and of x."""
    jargs = (jnp.asarray(x), jb.adj, jb.node_mask) + tuple(
        jnp.asarray(e) for e in extra)
    tx = torch.from_numpy(x).requires_grad_()
    targs = (tx, tb.adj, tb.node_mask) + tuple(
        torch.from_numpy(e) for e in extra)
    port = check_against_jax(jmodule, tmodule, jb, tb, train=False,
                             jax_args=jargs, port_args=targs)
    w = np.random.default_rng(1).standard_normal(
        port(*targs).shape).astype(np.float32)
    want = jax.grad(lambda a: (jmodule.apply(
        {"params": _params_of(port)}, a, *jargs[1:]) * w).sum())(jargs[0])
    assert_grads_close(tx.grad.numpy(), np.asarray(want), "x")


def _params_of(port):
    """The port module's parameters as a flax params tree (its `nn.Linear`
    weights transposed back to kernels)."""
    tree = {}
    for name, p in port.named_parameters():
        *scope, leaf = name.split(".")
        a = p.detach().numpy()
        if leaf == "weight":
            leaf, a = "kernel", a.T
        node = tree
        for s in scope:
            node = node.setdefault(s, {})
        node[leaf] = jnp.asarray(a)
    return tree


@pytest.mark.parametrize("add_self_loops", [True, False])
def test_dense_gcn_conv_matches_jax(add_self_loops):
    jb, tb = graphit_batches()
    x = np.random.default_rng(2).standard_normal((3, N_MAX, 6)).astype(
        np.float32)
    _module_case(jgnn.DenseGCNConv(5, add_self_loops=add_self_loops),
                 lambda: tgnn.DenseGCNConv(6, 5,
                                           add_self_loops=add_self_loops),
                 jb, tb, x)


@pytest.mark.parametrize("edges,train_eps", [(False, True), (True, True),
                                             (False, False)])
def test_dense_gine_plus_matches_jax(edges, train_eps):
    """Two hops over the adjacency's powers, with and without an edge
    field added before the ReLU."""
    jb, tb = graphit_batches()
    rng = np.random.default_rng(3)
    x = rng.standard_normal((3, N_MAX, 6)).astype(np.float32)
    extra = ((rng.standard_normal((3, N_MAX, N_MAX, 6)).astype(np.float32),)
             if edges else ())
    _module_case(jgnn.DenseGINEPlus(4, num_hops=2, train_eps=train_eps),
                 lambda: tgnn.DenseGINEPlus(6, 4, num_hops=2,
                                            train_eps=train_eps),
                 jb, tb, x, *extra)


@pytest.mark.parametrize("normalization", ["sym", "rw", None])
def test_dense_gengcn_matches_jax(normalization):
    jb, tb = graphit_batches()
    x = np.random.default_rng(4).standard_normal((3, N_MAX, 6)).astype(
        np.float32)
    _module_case(jgnn.DenseGENGCN(5, num_hops=3,
                                  normalization=normalization),
                 lambda: tgnn.DenseGENGCN(6, 5, num_hops=3,
                                          normalization=normalization),
                 jb, tb, x)


# ------------------------------- the TU trainer's nets without bond types

TU_NET_PARAMS = {"L": 2, "hidden_dim": 16, "out_dim": 16, "n_heads": 2,
                 "LPE_dim": 4, "LPE_n_heads": 2, "LPE_layers": 1,
                 "pos_enc_dim": 4}


def _tu_batches(cls_is_lspe, max_freqs=3):
    """The first 4 TUFIX graphs (float features, no bond types) as both
    packages read them, with the eigen-PE of `max_freqs` frequencies and,
    for the LSPE nets, 4 random-walk PE columns as `lap_pe`."""
    import os

    from feta_tmlr_tpu.data import batch as jbatch
    from feta_tmlr_tpu.data.tu import load_tu_dataset as jload
    from feta_tmlr_tpu.pe.laplace import apply_laplace_decomp as jeig
    from feta_tmlr_tpu.pe.rwpe import rwpe as jrwpe
    from feta_tmlr_tpu_torch.data import batch as tbatch
    from feta_tmlr_tpu_torch.data.tu import load_tu_dataset as tload
    from feta_tmlr_tpu_torch.pe.laplace import apply_laplace_decomp as teig
    from feta_tmlr_tpu_torch.pe.rwpe import apply_rwpe
    fixtures = os.path.join(os.path.dirname(__file__), "fixtures")
    jg = jload("TUFIX", fixtures)[0][:4]
    tg = tload("TUFIX", fixtures)[0][:4]
    jeig(jg, max_freqs)
    teig(tg, max_freqs)
    if cls_is_lspe:
        for g in jg:
            g.lap_pe = jrwpe(g, TU_NET_PARAMS["pos_enc_dim"])
        apply_rwpe(tg, TU_NET_PARAMS["pos_enc_dim"])
    n = max(g.num_nodes for g in tg)
    return jg, tg, jbatch.collate_graphs(jg, max_nodes=n), \
        tbatch.collate_graphs(tg, max_nodes=n)


@pytest.mark.parametrize("name", ["SAN", "SAN_NodeLPE", "SAN_EdgeLPE",
                                  "SAN_NodeSpectra", "GatedGCN", "PNA",
                                  "GraphiT", "Spectra"])
def test_tu_trainer_net_matches_jax(name):
    """Each of the TU trainer's eight nets as its `resolve_build` and
    `construct_model` make it (float features, `edge_features=False`: no
    bond embedding, no edge features in the attention; the SAN_EdgeLPE
    edge field the eigen-PE alone) against the JAX trainer's construction
    on the same graphs: eval-mode logits and every gradient."""
    from feta_tmlr_tpu.experiments import main_TU_graph_classification as jtu
    from feta_tmlr_tpu.experiments.common import set_accepted_defaults
    from feta_tmlr_tpu.nn.pna import average_log_degree
    from feta_tmlr_tpu.utils.config import model_kwargs_for
    from feta_tmlr_tpu_torch.experiments import (
        main_TU_graph_classification as ttu)
    cfg = {"model": name, "params": {}, "net_params": TU_NET_PARAMS}
    cls, kwargs = ttu.resolve_build(cfg)
    jg, tg, jb, tb = _tu_batches(cls in ttu.LSPE_MODELS)
    n_classes = len({int(g.y) for g in tg})
    jcls, extra = jtu.MODELS[name]
    jkw = model_kwargs_for(jcls, TU_NET_PARAMS)
    jkw.update(extra)
    set_accepted_defaults(jcls, jkw, hidden_dim=32, out_dim=32, n_heads=4,
                          n_layers=3, lpe_dim=8, categorical_input=False)
    if jcls is jtu.PNALSPENet:
        jkw.setdefault("avg_d_log", average_log_degree(jg))
    port = check_against_jax(
        jcls(num_atom_type=1, num_bond_type=1, n_out=n_classes, **jkw),
        lambda: ttu.construct_model(cls, kwargs, tg, n_classes,
                                    device="cpu"),
        jb, tb, train=False)
    assert not hasattr(port, "embedding_e")
