"""The port's SAN family (SANNet with no, node or edge eigen-PE on the
full and the sparse graph, typed bonds and the dense edge field;
SANSpectraLayer's options; SANNodeSpectra's remaining options) vs the JAX
package's `nn/san.py`, on the CPU.

Three graphs of 9, 7 and 6 nodes padded to 10, one with an isolated
node, bond types in [0, 4), the Laplacian eigen-PE of m = 10 frequencies
(NaN-padded beyond each graph's size), made with numpy from a seed. Both
sides start from the same weights (`convert.from_flax`, non-zero biases,
batch-norm statistics away from (0, 1)). The JAX FreqTransformer runs its
Pallas fused-MLP route in interpret mode (`fused_interpret`); the port's
runs the fused-MLP kernels' plain versions (CPU tensors).

Each case holds the outputs (eval mode: dropout off, batch norm on its
running statistics) at rtol 5e-4 / atol 5e-5 and the gradients of a fixed
random projection of them with respect to every parameter at rtol 1e-3 /
atol 1e-5, tests/test_torch_san.py's model and gradient tolerances; a
gradient tensor whose largest entry exceeds 1 takes atol 1e-5 times that
entry (an entry that cancels down from terms of that size keeps their
float32 rounding: 8e-5 on a 0.006 entry of a tensor reaching 4).
Dropout (the port's hash masks, drawn from the model's generator; the JAX
nets draw from flax's RNG) is held to its keep rate and its seeding.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from feta_tmlr_tpu.data import batch as jbatch
from feta_tmlr_tpu.nn import san as jsan
from feta_tmlr_tpu.pe.laplace import apply_laplace_decomp as j_eig
from feta_tmlr_tpu_torch.convert import from_flax
from feta_tmlr_tpu_torch.data import batch as tbatch
from feta_tmlr_tpu_torch.nn import san as tsan
from feta_tmlr_tpu_torch.ops.kernels import fused_mlp as tfm
from feta_tmlr_tpu_torch.ops.kernels.fused_mlp import dropout_keep
from feta_tmlr_tpu_torch.pe.laplace import apply_laplace_decomp as t_eig
from test_torch_san import _np, _perturb, fused_interpret  # noqa: F401

MODEL_TOL = dict(rtol=5e-4, atol=5e-5)
GRAD_TOL = dict(rtol=1e-3, atol=1e-5)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """These tests run many small torch ops: one intra-op thread each,
    where the suite's parallel workers would otherwise oversubscribe the
    cores (the setting is restored after each test)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def assert_grads_close(got, want, name):
    """GRAD_TOL, its atol scaled by the tensor's largest entry past 1."""
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=GRAD_TOL["rtol"],
                               atol=GRAD_TOL["atol"] * scale, err_msg=name)
N_MAX = 10
M_FREQS = 10
SIZES = (9, 7, 6)
ISOLATED = (1, 6)             # graph 1's node 6 has no edge
BASE = dict(num_atom_type=28, num_bond_type=4, hidden_dim=16, out_dim=16,
            n_heads=4, n_layers=2, lpe_dim=4, lpe_heads=2, lpe_layers=1,
            gamma=0.1)


def lpe_graphs(pkg, seed=3, float_x=0):
    """SIZES-node graphs: a path through the nodes plus random chords,
    symmetric bond types in [0, 4), int atom ids (or `float_x` float
    features), a scalar label; ISOLATED's node left without edges."""
    rng = np.random.default_rng(seed)
    graphs = []
    for gi, n in enumerate(SIZES):
        live = [v for v in range(n) if (gi, v) != ISOLATED]
        pairs = {tuple(sorted(p)) for p in zip(live[:-1], live[1:])}
        for _ in range(n // 2):
            a, b = rng.choice(live, 2, replace=False)
            pairs.add((min(a, b), max(a, b)))
        pairs = sorted(pairs)
        types = rng.integers(0, BASE["num_bond_type"], len(pairs))
        src = [a for a, b in pairs] + [b for a, b in pairs]
        dst = [b for a, b in pairs] + [a for a, b in pairs]
        x = (rng.standard_normal((n, float_x)).astype(np.float32) if float_x
             else rng.integers(0, BASE["num_atom_type"], (n, 1)).astype(
                 np.int32))
        graphs.append(pkg.Graph(
            x=x, edge_index=np.array([src, dst], np.int32),
            edge_type=np.concatenate([types, types]).astype(np.int32),
            y=np.float32(rng.standard_normal())))
    return graphs


def lpe_batches(float_x=0):
    """(JAX batch, port batch) of the three graphs with their eigen-PE."""
    jg, tg = lpe_graphs(jbatch, float_x=float_x), \
        lpe_graphs(tbatch, float_x=float_x)
    j_eig(jg, M_FREQS)
    t_eig(tg, M_FREQS)
    return (jbatch.collate_graphs(jg, max_nodes=N_MAX),
            tbatch.collate_graphs(tg, max_nodes=N_MAX))


def random_variables(jmodule, *args, seed=0, **kwargs):
    """Variables of the shapes `jmodule.init` gives (traced, not run: an
    eager init compiles every op), drawn with numpy: kernels and tables
    N(0, 1/fan_in), scales 1 + N(0, 0.05^2), biases N(0, 0.05^2) and
    batch-norm statistics as `_perturb` draws them."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda: jmodule.init(jax.random.key(0), *args,
                                                 **kwargs))

    def draw(path, leaf):
        name, shape = path[-1].key, leaf.shape
        n = rng.standard_normal(shape).astype(np.float32)
        if name == "scale":
            return 1.0 + 0.05 * n
        if name == "bias" or len(shape) < 2:
            return 0.05 * n
        return n / np.float32(np.sqrt(np.prod(shape[:-1])))

    params = jax.tree_util.tree_map_with_path(draw, shapes["params"])
    out = {"params": params}
    if "batch_stats" in shapes:
        out["batch_stats"] = _perturb(
            {"params": {}, "batch_stats": jax.tree.map(
                lambda a: np.zeros(a.shape, np.float32),
                shapes["batch_stats"])}, seed)["batch_stats"]
    return out


def check_net(jmodel, port_cls, port_kw, jb, tb, seed=0):
    """Draw the JAX net's weights (`random_variables`), copy them into the
    port's, and hold the eval-mode outputs and the gradients of
    sum(out * w) with respect to every parameter to the JAX net's.
    Returns the port model."""
    variables = random_variables(jmodel, jb, seed=seed)
    params, stats = variables["params"], variables.get("batch_stats", {})
    shape = jax.eval_shape(lambda: jmodel.apply(variables, jb)).shape
    w = np.random.default_rng(seed + 1).standard_normal(shape).astype(
        np.float32)

    def loss(p):
        out = jmodel.apply({"params": p, "batch_stats": stats}, jb)
        return (out * jnp.asarray(w)).sum(), out

    (_, out), jgrads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        params)
    jgrads = _np(jgrads)
    port = from_flax(variables, port_cls(**port_kw, device="cpu")).eval()
    got = port(tb)
    assert got.shape == out.shape
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out),
                               **MODEL_TOL)
    (got * torch.from_numpy(w)).sum().backward()
    want = dict(from_flax({"params": jgrads, "batch_stats": _np(stats)},
                          port_cls(**port_kw, device="cpu"))
                .named_parameters())
    for name, p in port.named_parameters():
        assert_grads_close(p.grad.numpy(), want[name].detach().numpy(), name)
    return port


# ----------------------------------------------------------------- SANNet

@pytest.mark.parametrize("lpe,full_graph,typed_edges,readout", [
    ("none", True, None, "mean"), ("none", False, None, "sum"),
    ("node", True, None, "max"), ("node", False, None, "mean"),
    ("edge", True, None, "sum"), ("edge", False, None, "mean"),
    ("none", True, False, "mean"), ("node", False, False, "sum")])
def test_san_net_matches_jax(fused_interpret, lpe, full_graph, typed_edges,
                             readout):
    """typed_edges None: the typed route for "none" / "node" (4 bond
    types), the dense edge field for "edge"; False forces the field."""
    kw = dict(BASE, lpe=lpe, full_graph=full_graph, readout=readout,
              typed_edges=typed_edges)
    jb, tb = lpe_batches()
    port = check_net(jsan.SANNet(**kw), tsan.SANNet, kw, jb, tb)
    assert hasattr(port, "pe_transformer") == (lpe != "none")
    layer = port.layers[0].attention
    assert hasattr(layer, "Q_2") == full_graph
    assert port.typed_edges == (typed_edges is None and lpe != "edge")


def test_edge_lpe_transformer_matches_jax(fused_interpret):
    """The pair tokens, their frequency mask (NaN beyond a graph's size
    and on padded nodes) and the pair mask, through the FreqTransformer
    over B*N*N*m rows."""
    jb, tb = lpe_batches()
    jmod = jsan.EdgeLPETransformer(lpe_dim=4, lpe_heads=2, lpe_layers=2)
    args = (jnp.asarray(jb.eigvecs), jnp.asarray(jb.eigvals),
            jnp.asarray(jb.node_mask))
    variables = random_variables(jmod, *args, seed=2)
    want = jax.jit(jmod.apply)(variables, *args)
    port = from_flax(variables, tsan.EdgeLPETransformer(4, 2, 2)).eval()
    got = port(tb.eigvecs, tb.eigvals, tb.node_mask)
    assert got.shape == (3, N_MAX, N_MAX, 4)
    assert not torch.isnan(got).any()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **MODEL_TOL)
    pm = tb.node_mask[:, :, None] & tb.node_mask[:, None, :]
    assert torch.all(got[~pm] == 0)


# --------------------------------------------------------- spectra layer

@pytest.mark.parametrize("opts", [
    dict(out_dim=12, layer_norm=True, residual=False),
    dict(out_dim=16, layer_norm=True, residual=True, full_graph=False),
    dict(out_dim=12, batch_norm=False, residual=True, spectra=False),
], ids=["ln-no-residual-narrow", "ln-sparse", "no-norm-narrow-plain"])
def test_spectra_layer_options_match_jax(fused_interpret, opts):
    """Layer norm (ln_norm1 / ln_norm2), no norm, residual off, out_dim
    != the input width (no first residual), the sparse graph, the plain
    SAN layer; outputs and the gradients of the parameters and of h."""
    jb, tb = lpe_batches()
    mask = np.asarray(jb.node_mask)
    h = np.random.default_rng(4).standard_normal((3, N_MAX, 16)).astype(
        np.float32) * mask[..., None]
    table = np.random.default_rng(5).standard_normal((4, 16)).astype(
        np.float32)
    jmod = jsan.SANSpectraLayer(num_heads=4, filter_order=3, **opts)
    ekw = dict(e_table=jnp.asarray(table), edge_ids=jnp.asarray(jb.edge_type))
    args = (None, jnp.asarray(jb.adj), jnp.asarray(mask))
    variables = random_variables(jmod, jnp.asarray(h), *args, **ekw)
    w = np.random.default_rng(6).standard_normal(
        (3, N_MAX, opts["out_dim"])).astype(np.float32)

    def loss(p, hh):
        out = jmod.apply({**variables, "params": p}, hh, *args, **ekw)
        return (out * jnp.asarray(w)).sum(), out

    (_, want), (jgrads, jdh) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(variables["params"],
                                             jnp.asarray(h))
    port_kw = {k: v for k, v in opts.items() if k != "out_dim"}
    make = lambda: tsan.SANSpectraLayer(16, opts["out_dim"], 4,
                                        filter_order=3, **port_kw)
    port = from_flax(variables, make()).eval()
    th = torch.from_numpy(h).requires_grad_()
    got = port(th, tb.adj, tb.node_mask, e_table=torch.from_numpy(table),
               edge_ids=tb.edge_type)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **MODEL_TOL)
    (got * torch.from_numpy(w)).sum().backward()
    assert_grads_close(th.grad.numpy(), np.asarray(jdh), "h")
    grads = dict(from_flax({**variables, "params": _np(jgrads)}, make())
                 .named_parameters())
    for name, p in port.named_parameters():
        assert_grads_close(p.grad.numpy(), grads[name].detach().numpy(),
                           name)
    norms = {n.split(".")[0] for n, _ in port.named_parameters()
             if "norm" in n}
    want_norms = ({"ln_norm1", "ln_norm2"} if opts.get("layer_norm")
                  else set())
    assert norms == want_norms


# ---------------------------------------------------------- NodeSpectra

@pytest.mark.parametrize("opts,float_x", [
    (dict(full_graph=False, dropout=0.1, in_feat_dropout=0.1), 0),
    (dict(last_layer_filter=True, layer_norm=True), 0),
    (dict(node_level=True, n_out=3, residual=False), 0),
    (dict(categorical_input=False, readout="sum"), 5),
], ids=["sparse", "last-layer-filter", "node-level", "float-input"])
def test_san_node_spectra_options_match_jax(fused_interpret, opts, float_x):
    """The options the ZINC slice refused: the sparse graph,
    last_layer_filter (only the last layer filters: its parameters
    exist only there), layer dropout and input dropout (inert in eval
    mode), layer norm, residual off, the node-level readout and float
    node features through a Dense embedding."""
    kw = dict(BASE, filter_order=3, **opts)
    jb, tb = lpe_batches(float_x=float_x)
    port_kw = dict(kw, in_feat_dim=float_x) if float_x else kw
    port = check_net(jsan.SANNodeSpectra(**kw), tsan.SANNodeSpectra,
                     port_kw, jb, tb)
    filtered = [hasattr(layer, "cheb_weight") for layer in port.layers]
    if opts.get("last_layer_filter"):
        assert filtered == [False, True]
    else:
        assert all(filtered)


# ---------------------------------------------------------------- dropout

def test_hash_dropout_keep_rate_and_scale():
    gen = torch.Generator().manual_seed(0)
    t = torch.ones(4000, 64)
    for rate in (0.1, 0.5):
        out = tsan.hash_dropout(t, rate, gen)
        kept = out != 0
        assert abs(float(kept.float().mean()) - (1 - rate)) < 0.005
        assert torch.allclose(out[kept], torch.tensor(1 / (1 - rate)))
    assert tsan.hash_dropout(t, 0.0, gen) is t


@pytest.mark.parametrize("lpe", ["none", "edge"])
def test_san_net_dropout_is_seeded_and_train_only(lpe):
    """Layer and input dropout 0.2: one seed of the model's generator
    gives one output, another seed another; the masks are the kernels'
    hash of the drawn seeds (a seed is drawn per use); eval draws none."""
    _, tb = lpe_batches()
    model = tsan.SANNet(**dict(BASE, lpe=lpe, dropout=0.2,
                               in_feat_dropout=0.2), device="cpu").train()
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
    gen = torch.Generator().manual_seed(9)
    seed = tsan.draw_seed(torch.Generator().manual_seed(9))
    h = torch.ones(30, 16)
    keep = dropout_keep(seed, 30, 16, 0.2)
    assert torch.equal(tsan.hash_dropout(h, 0.2, gen) != 0, keep)


def test_fused_mlp_wrapper_refuses_rows_past_int():
    """The kernels' row index is a C int: 2^31 rows raise before a launch
    (meta tensors: shapes without memory)."""
    t = lambda *s: torch.empty(s, device="meta")
    args = (t(2 ** 31, 8), t(8, 2048), t(2048), t(2048, 8))
    with pytest.raises(ValueError, match="rows below 2\\^31"):
        tfm._check("fused_mlp_fwd", *args, [("b2", t(8), (8,))])
    assert tfm._check("fused_mlp_fwd", t(2 ** 31 - 1, 8), *args[1:],
                      [("b2", t(8), (8,))]) == (2 ** 31 - 1, 8, 2048, 8)
