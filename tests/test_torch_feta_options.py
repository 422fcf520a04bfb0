"""The FeTA filter's options in the port (`nn/feta.py`, `ops/arma.py`,
`ops/lambda_max.py`, `ops/laplacian.py`) vs the JAX package, on the CPU.

The graphs are `test_torch_san_family`'s three graphs of 9, 7 and 6 nodes
padded to 10 (one isolated node), with 7 float features, the degree
feature, the diffusion kernel as `pe` and 4 Laplacian-PE columns, made
with numpy from a seed. Both sides start from the same weights
(`random_variables`, copied by `convert.from_flax`). Each model case holds
the train-mode outputs and regularizer (dropout 0: batch statistics, whose
running updates are held too) at rtol 5e-4 / atol 5e-5 and the gradients
of a fixed random projection of them with respect to every parameter at
rtol 1e-3 / atol 1e-5 times the tensor's largest entry past 1
(tests/test_torch_san_family.py's tolerances). The JAX models run their
default XLA route, except where the fixture `jax_flash_path`
(tests/test_torch_layers.py) puts them on the Pallas flash kernels in
interpret mode. The dense ops are held at rtol 1e-5 / atol 1e-6 (float32,
the same operations in another order); lambda_max at rtol 1e-5.
"""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from feta_tmlr_tpu.data import batch as jbatch
from feta_tmlr_tpu.nn import feta as jfeta
from feta_tmlr_tpu.nn import models as jmodels
from feta_tmlr_tpu.ops import arma as jarma
from feta_tmlr_tpu.ops import lambda_max as jlam
from feta_tmlr_tpu.ops import laplacian as jlap
from feta_tmlr_tpu.pe import encodings as jpe
from feta_tmlr_tpu_torch.convert import from_flax
from feta_tmlr_tpu_torch.data import batch as tbatch
from feta_tmlr_tpu_torch.nn import feta as tfeta
from feta_tmlr_tpu_torch.nn import models as tmodels
from feta_tmlr_tpu_torch.ops import arma as tarma
from feta_tmlr_tpu_torch.ops import lambda_max as tlam
from feta_tmlr_tpu_torch.ops import laplacian as tlap
from feta_tmlr_tpu_torch.pe import encodings as tpe
from feta_tmlr_tpu_torch.train.trainer import TrainConfig, Trainer
from test_torch_layers import jax_flash_path  # noqa: F401 (fixture)
from test_torch_san import _np
from test_torch_san_family import (
    MODEL_TOL,
    N_MAX,
    assert_grads_close,
    lpe_graphs,
    random_variables,
)

OPS_TOL = dict(rtol=1e-5, atol=1e-6)
CFG = dict(in_size=7, nb_class=3, d_model=16, nb_heads=2,
           dim_feedforward=32, dropout=0.0, nb_layers=2, batch_norm=True,
           lap_pos_enc=True, lap_pos_enc_dim=4, filter_order=3)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Many small torch ops: one intra-op thread each, where the suite's
    parallel workers would otherwise oversubscribe the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def graphit_batches(seed=3):
    """(JAX batch, port batch): the three graphs with float features, the
    degree feature, the diffusion kernel and 4 Laplacian-PE columns."""
    out = []
    for pkg, pe in ((jbatch, jpe), (tbatch, tpe)):
        graphs = lpe_graphs(pkg, seed=seed, float_x=CFG["in_size"])
        for g in graphs:
            g.compute_degree_feature()
        pe.DiffusionEncoding(beta=1.0).apply_to(graphs)
        pe.LapEncoding(CFG["lap_pos_enc_dim"]).apply_to(graphs)
        out.append(pkg.collate_graphs(graphs, max_nodes=N_MAX))
    return out


def _grad_or_zero(p):
    return (p.grad.numpy() if p.grad is not None
            else np.zeros(tuple(p.shape), np.float32))


def _first(out):
    return out[0] if isinstance(out, tuple) else out


def _second(out):
    return out[1] if isinstance(out, tuple) else 0.0


def check_against_jax(jmodel, make_port, jb, tb, seed=0, train=True,
                      call_kw=None, jax_args=None, port_args=None,
                      first=_first, second=_second):
    """The JAX module's weights drawn by `random_variables` and copied into
    `make_port()`; the outputs (`first`: the logits, the first of a tuple;
    `second`: a scalar, the regularizer where there is one), the gradients
    of sum(logits * w) + 3 * that scalar with respect to every parameter
    and, in train mode, the running statistics held to JAX's. Returns the
    port module."""
    call_kw = call_kw or {}
    jax_args = jax_args if jax_args is not None else (jb,)
    port_args = port_args if port_args is not None else (tb,)
    variables = random_variables(jmodel, *jax_args, seed=seed)
    params, stats = variables["params"], variables.get("batch_stats", {})

    def apply(p):
        v = {"params": p, "batch_stats": stats}
        if train:
            return jmodel.apply(v, *jax_args, deterministic=False,
                                mutable=["batch_stats"], **call_kw)
        return jmodel.apply(v, *jax_args, **call_kw), {"batch_stats": stats}

    out_shape = jax.eval_shape(lambda: apply(params)[0])
    w = np.random.default_rng(seed + 1).standard_normal(
        first(out_shape).shape).astype(np.float32)

    def loss(p):
        out, new = apply(p)
        return (first(out) * jnp.asarray(w)).sum() + 3.0 * second(out), (
            out, new)

    (_, (out, new)), jgrads = jax.jit(jax.value_and_grad(
        loss, has_aux=True))(params)
    port = from_flax(variables, make_port()).train(train)
    got = port(*port_args, **call_kw)
    np.testing.assert_allclose(first(got).detach().numpy(),
                               np.asarray(first(out)), **MODEL_TOL)
    got_reg = second(got)
    np.testing.assert_allclose(
        float(got_reg.detach()) if torch.is_tensor(got_reg) else got_reg,
        float(second(out)), **MODEL_TOL)
    reg = got_reg if torch.is_tensor(got_reg) else 0.0
    ((first(got) * torch.from_numpy(w)).sum() + 3.0 * reg).backward()
    want = dict(from_flax({"params": _np(jgrads), "batch_stats": _np(stats)},
                          make_port()).named_parameters())
    for name, p in port.named_parameters():
        assert_grads_close(_grad_or_zero(p), want[name].detach().numpy(),
                           name)
    if train and stats:
        new_stats = dict(from_flax({"params": _np(params),
                                    "batch_stats": _np(new["batch_stats"])},
                                   make_port()).named_buffers())
        for name, buf in port.named_buffers():
            np.testing.assert_allclose(buf.numpy(), new_stats[name].numpy(),
                                       err_msg=name, **MODEL_TOL)
    return port


# ------------------------------------------------------------------- ops

def _adjacency(seed, b=3, n=N_MAX):
    """Symmetric weighted adjacencies with padded nodes, an isolated real
    node and some self loops."""
    rng = np.random.default_rng(seed)
    mask = np.ones((b, n), bool)
    mask[0, n - 3:] = False
    mask[2, n - 5:] = False
    a = rng.random((b, n, n)) * (rng.random((b, n, n)) < 0.4)
    a = np.maximum(a, a.transpose(0, 2, 1)).astype(np.float32)
    a[1, 4, :] = a[1, :, 4] = 0.0
    a[0, 2, 2] = a[1, 1, 1] = 0.7
    return a, mask


@pytest.mark.parametrize("add_self_loops", [True, False])
def test_gcn_norm_dense_matches_jax(add_self_loops):
    a, mask = _adjacency(0)
    want = jlap.gcn_norm_dense(jnp.asarray(a), jnp.asarray(mask),
                               add_self_loops=add_self_loops)
    got = tlap.gcn_norm_dense(torch.from_numpy(a), torch.from_numpy(mask),
                              add_self_loops=add_self_loops)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **OPS_TOL)


@pytest.mark.parametrize("normalization", ["sym", "rw", None])
def test_graph_laplacian_dense_matches_jax(normalization):
    a, mask = _adjacency(1)
    want = jlap.graph_laplacian_dense(jnp.asarray(a), jnp.asarray(mask),
                                      normalization)
    got = tlap.graph_laplacian_dense(torch.from_numpy(a),
                                     torch.from_numpy(mask), normalization)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **OPS_TOL)
    assert not got[~torch.from_numpy(mask)].any()


@pytest.mark.parametrize("n", [N_MAX, 80])
def test_arma_filter_matches_jax_with_gradients(n):
    """`gcn_norm_no_self_loops` and the ARMA filter, its output and the
    gradients of every operand (at N = 80 the node products run in
    `node_matmul`'s blocks of 64)."""
    a, mask = _adjacency(2, n=n)
    rng = np.random.default_rng(3)
    b, h, d, k = 3, 2, 4, 3
    x = rng.standard_normal((b, h, n, d)).astype(np.float32)
    coeff = rng.standard_normal((b, h, 2 * k)).astype(np.float32)
    w_init, w_root = (0.5 * rng.standard_normal((k, d, d)).astype(np.float32)
                      for _ in range(2))
    bias = 0.1 * rng.standard_normal((k, 1, d)).astype(np.float32)
    g = rng.standard_normal((b, h, n, d)).astype(np.float32)
    j_an = jarma.gcn_norm_no_self_loops(jnp.asarray(a), jnp.asarray(mask))
    t_an = tarma.gcn_norm_no_self_loops(torch.from_numpy(a),
                                        torch.from_numpy(mask))
    np.testing.assert_allclose(t_an.numpy(), np.asarray(j_an), **OPS_TOL)
    ops = (x, coeff, w_init, w_root, bias)

    def jloss(*args):
        out = jarma.arma_filter_dynamic(args[0], j_an, *args[1:],
                                        activation=jax.nn.relu)
        return (out * g).sum(), out

    (_, want), jgrads = jax.value_and_grad(
        jloss, argnums=tuple(range(5)), has_aux=True)(
            *(jnp.asarray(o) for o in ops))
    tops = [torch.from_numpy(o).requires_grad_() for o in ops]
    got = tarma.arma_filter_dynamic(tops[0], t_an, *tops[1:],
                                    activation=torch.relu)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **MODEL_TOL)
    (got * torch.from_numpy(g)).sum().backward()
    for name, t, jg in zip(("x", "coeff", "init", "root", "bias"), tops,
                           jgrads):
        assert_grads_close(t.grad.numpy(), np.asarray(jg), name)


@pytest.mark.parametrize("normalization", [None, "rw", "sym"])
def test_lambda_max_matches_jax_and_float64(normalization):
    """50 power steps from the same start: float32 against JAX's float32,
    and against the port's own float64 run (no host sync: a fixed count of
    steps)."""
    a, mask = _adjacency(4)
    want = jlam.laplacian_lambda_max(jnp.asarray(a), jnp.asarray(mask),
                                     normalization)
    got = tlam.laplacian_lambda_max(torch.from_numpy(a),
                                    torch.from_numpy(mask), normalization)
    got64 = tlam.laplacian_lambda_max(torch.from_numpy(a).double(),
                                      torch.from_numpy(mask), normalization)
    assert got.shape == (3,) and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)
    np.testing.assert_allclose(got.numpy(), got64.numpy(), rtol=1e-5)
    lap = tlap.graph_laplacian_dense(torch.from_numpy(a).double(),
                                     torch.from_numpy(mask), normalization)
    top = np.abs(np.linalg.eigvals(lap.numpy())).max(-1)
    assert np.all(got64.numpy() <= top * (1 + 1e-6))


# ------------------------------------------------------- the FeTA models

OPTIONS = [
    dict(gnn_type="ARMAConvDynamic"),
    dict(last_layer_filter=False),
    dict(learn_only_filter_order_coeff=True),
    dict(use_skip_conn=False),
    dict(use_skip_conn=False, last_layer_filter=False),
    dict(gnn_type="ARMAConvDynamic", last_layer_filter=False,
         use_skip_conn=False),
    dict(gnn_type="GCN"),
    dict(remat=True),
    dict(scan_layers=True, nb_layers=3),
]


@pytest.mark.parametrize("opts", OPTIONS, ids=lambda o: "-".join(
    f"{k}={v}" for k, v in o.items()))
def test_feta_model_option_matches_jax(opts):
    """DiffGraphTransformerGenGCN under one option of the FeTA encoder:
    train-mode logits, the coefficient regularizer over every filtered
    layer's coefficients, the running statistics and every parameter's
    gradient. With scan_layers the JAX model stacks its first layers under
    `scan_layers/layer` and `from_flax` unstacks them into a port model
    of the same depth, which takes no such option."""
    jb, tb = graphit_batches()
    cfg = {**CFG, **opts}
    port_cfg = {k: v for k, v in cfg.items() if k != "scan_layers"}
    check_against_jax(
        jmodels.DiffGraphTransformerGenGCN(**cfg),
        lambda: tmodels.DiffGraphTransformerGenGCN(**port_cfg, device="cpu"),
        jb, tb, call_kw=dict(regularization=0.1))


@pytest.mark.parametrize("opts", [
    dict(gnn_type="ARMAConvDynamic"), dict(last_layer_filter=False)],
    ids=["arma", "every-layer"])
def test_feta_option_matches_jax_on_the_pallas_flash_route(jax_flash_path,
                                                           opts):
    """ARMA and the filter in every layer against the JAX model on its
    Pallas flash kernels, interpreted (the filtered layers' column
    statistics from `_colstat_kernel`): eval-mode logits and
    regularizer."""
    jb, tb = graphit_batches(seed=5)
    cfg = {**CFG, **opts}
    check_against_jax(
        jmodels.DiffGraphTransformerGenGCN(**cfg),
        lambda: tmodels.DiffGraphTransformerGenGCN(**cfg, device="cpu"),
        jb, tb, seed=2, train=False, call_kw=dict(regularization=0.1))


@pytest.mark.parametrize("laplacian_norm", ["rw", None])
def test_feta_encoder_non_sym_laplacian_matches_jax(laplacian_norm):
    """The encoder alone under a normalization without a spectral bound:
    each graph's lambda_max from the power iteration scales the Chebyshev
    filter. Held: the encoder's output, the sum of its squared
    coefficients and their gradients."""
    jb, tb = graphit_batches(seed=7)
    x = np.random.default_rng(8).standard_normal(
        (3, N_MAX, CFG["d_model"])).astype(np.float32)
    kw = dict(d_model=16, n_heads=2, n_layers=2, dim_feedforward=32,
              dropout=0.0, batch_norm=True, filter_order=3,
              laplacian_norm=laplacian_norm)
    jargs = (jnp.asarray(x), jb.pe, jb.adj, jb.node_mask, jb.degree)
    targs = (torch.from_numpy(x), tb.pe, tb.adj, tb.node_mask, tb.degree)
    check_against_jax(jfeta.FeTAEncoder(**kw),
                      lambda: tfeta.FeTAEncoder(**kw), jb, tb,
                      jax_args=jargs, port_args=targs,
                      second=lambda out: (out[2] ** 2).sum())


def test_remat_step_equals_the_plain_step():
    """A Trainer step with `remat` (dropout 0.1: the recomputed forward
    replays the masks) against the same step without it, from the same
    weights and the same global seed: loss, gradients, updated weights and
    batch-norm statistics bit-equal (the recomputation does not update the
    running statistics a second time)."""
    _, tb = graphit_batches()
    cfg = dict(CFG, dropout=0.1, nb_layers=3, nb_class=1)
    base = tmodels.DiffGraphTransformerGenGCN(**cfg, seed=4, device="cpu")
    runs = []
    for remat in (False, True):
        model = copy.deepcopy(base)
        model.encoder.remat = remat
        torch.manual_seed(11)
        loss = Trainer(model, TrainConfig(task="graph_reg",
                                          sign_flip=False)).step(tb)
        runs.append((loss, model))
    (l0, m0), (l1, m1) = runs
    assert torch.equal(l0, l1)
    for (name, p0), p1 in zip(m0.named_parameters(), m1.parameters()):
        assert torch.equal(p0.grad, p1.grad), name
        assert torch.equal(p0, p1), name
    for (name, b0), b1 in zip(m0.named_buffers(), m1.buffers()):
        assert torch.equal(b0, b1), name
    assert not torch.equal(m0.encoder.layers[0].norm1.mean,
                           base.encoder.layers[0].norm1.mean)


def test_scan_layers_layout_must_match():
    """The stacked layout of a 3-layer flax model: `from_flax` gives layer
    i of the port model the stack's i-th slice and the last layer its own
    leaves; a port model of another depth leaves leaves unused or missing,
    and the load raises."""
    jb, _ = graphit_batches()
    cfg = {**CFG, "nb_layers": 3}
    variables = random_variables(
        jmodels.DiffGraphTransformerGenGCN(**cfg, scan_layers=True), jb)
    enc = variables["params"]["encoder"]
    assert set(enc) >= {"scan_layers", "layer_2"} and "layer_0" not in enc
    model = from_flax(variables, tmodels.DiffGraphTransformerGenGCN(
        **cfg, device="cpu"))
    stacked = np.asarray(enc["scan_layers"]["layer"]["qkv"])
    for i in range(2):
        np.testing.assert_array_equal(
            model.encoder.layers[i].qkv.detach().numpy(), stacked[i])
    np.testing.assert_array_equal(
        model.encoder.layers[2].qkv.detach().numpy(),
        np.asarray(enc["layer_2"]["qkv"]))
    for depth in (2, 4):
        with pytest.raises(KeyError):
            from_flax(variables, tmodels.DiffGraphTransformerGenGCN(
                **{**cfg, "nb_layers": depth}, device="cpu"))


def test_unknown_dynamic_filter_raises():
    with pytest.raises(NotImplementedError, match="GCNDynamic"):
        tmodels.DiffGraphTransformerGenGCN(**CFG, gnn_type="GCNDynamic",
                                           device="cpu")
