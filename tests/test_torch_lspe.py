"""The port's LSPE tier GraphiT and SAN nets (`nn/lspe.py`,
`nn/san_lspe.py`) and its random-walk PE (`pe/rwpe.py`) vs the JAX
package, on the CPU.

The graphs are `test_torch_san_family`'s three graphs of 9, 7 and 6 nodes
padded to 10 (one isolated node, bond types in [0, 4)), with the
random-walk PE of 6 columns as `lap_pe` and the 3-step kernel (I - L/4)^3
as `pe`, made with numpy from a seed. Both sides start from the same
weights (`convert.from_flax`, non-zero biases, batch-norm statistics away
from (0, 1)). Each case holds the outputs at rtol 5e-4 / atol 5e-5 and the
gradients of a fixed random projection of them with respect to every
parameter (and the inputs where a layer is tested alone) at rtol 1e-3 /
atol 1e-5 times the tensor's largest entry past 1:
tests/test_torch_san_family.py's tolerances. A parameter that the output
does not reach has no torch gradient and a zero JAX one. `rwpe` is held
exactly.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from feta_tmlr_tpu.data import batch as jbatch
from feta_tmlr_tpu.nn import lspe as jlspe
from feta_tmlr_tpu.nn import san_lspe as jsan_lspe
from feta_tmlr_tpu.pe import PStepRWEncoding as JPStep
from feta_tmlr_tpu.pe.rwpe import rwpe as jrwpe
from feta_tmlr_tpu_torch.convert import from_flax
from feta_tmlr_tpu_torch.data import batch as tbatch
from feta_tmlr_tpu_torch.nn import lspe as tlspe
from feta_tmlr_tpu_torch.nn import san_lspe as tsan_lspe
from feta_tmlr_tpu_torch.pe import PStepRWEncoding as TPStep
from feta_tmlr_tpu_torch.pe.rwpe import rwpe as trwpe
from test_torch_san import _np
from test_torch_san_family import (
    MODEL_TOL,
    N_MAX,
    assert_grads_close,
    lpe_graphs,
    random_variables,
)

POS_DIM = 6
P_STEPS = 3
BASE = dict(num_atom_type=28, num_bond_type=4, hidden_dim=16, out_dim=16,
            n_heads=4, n_layers=2, pos_enc_dim=POS_DIM)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """These tests run many small torch ops: one intra-op thread each,
    where the suite's parallel workers would otherwise oversubscribe the
    cores (the setting is restored after each test)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def lspe_batches(with_coo=False, float_x=0):
    """(JAX batch, port batch) of the three graphs with their random-walk
    PE (`lap_pe`) and p-step kernel (`pe`), each side's own transforms."""
    jg = lpe_graphs(jbatch, float_x=float_x)
    tg = lpe_graphs(tbatch, float_x=float_x)
    for a, b in zip(jg, tg):
        a.lap_pe, b.lap_pe = jrwpe(a, POS_DIM), trwpe(b, POS_DIM)
    JPStep(p=P_STEPS, beta=0.25, normalization="sym").apply_to(jg)
    TPStep(p=P_STEPS, beta=0.25, normalization="sym").apply_to(tg)
    return (jbatch.collate_graphs(jg, max_nodes=N_MAX, with_coo=with_coo),
            tbatch.collate_graphs(tg, max_nodes=N_MAX, with_coo=with_coo))


def _grad_or_zero(p):
    return (np.zeros(tuple(p.shape), np.float32) if p.grad is None
            else p.grad.numpy())


def check_model(jmodel, port_cls, port_kw, jb, tb, seed=0, train=False,
                set_params=None):
    """Draw the JAX net's weights (then `set_params(params)` edits them in
    place, where given), copy them into the port's, and hold
    the outputs (eval mode, or train mode at dropout 0: batch statistics,
    whose running updates are held too) and the gradients of sum(out * w)
    (+ 3 * the auxiliary loss term, where the net returns one) with
    respect to every parameter to the JAX net's. Returns the port model."""
    variables = random_variables(jmodel, jb, seed=seed)
    params, stats = variables["params"], variables.get("batch_stats", {})
    if set_params is not None:
        set_params(params)

    def apply(p):
        v = {"params": p, "batch_stats": stats}
        if train:
            return jmodel.apply(v, jb, deterministic=False,
                                mutable=["batch_stats"])
        return jmodel.apply(v, jb), {"batch_stats": stats}

    out_shape = jax.eval_shape(lambda: apply(params)[0])
    aux = isinstance(out_shape, tuple)
    shape = (out_shape[0] if aux else out_shape).shape
    w = np.random.default_rng(seed + 1).standard_normal(shape).astype(
        np.float32)

    def loss(p):
        out, new = apply(p)
        logits, extra = out if aux else (out, 0.0)
        return (logits * jnp.asarray(w)).sum() + 3.0 * extra, (out, new)

    (_, (out, new)), jgrads = jax.jit(jax.value_and_grad(
        loss, has_aux=True))(params)
    make = lambda: port_cls(**port_kw, device="cpu")
    port = from_flax(variables, make()).train(train)
    got = port(tb)
    got_logits, got_extra = got if aux else (got, torch.zeros(()))
    want_logits, want_extra = out if aux else (out, 0.0)
    assert got_logits.shape == want_logits.shape
    np.testing.assert_allclose(got_logits.detach().numpy(),
                               np.asarray(want_logits), **MODEL_TOL)
    np.testing.assert_allclose(float(got_extra.detach()), float(want_extra),
                               **MODEL_TOL)
    ((got_logits * torch.from_numpy(w)).sum() + 3.0 * got_extra).backward()
    want = dict(from_flax({"params": _np(jgrads), "batch_stats": _np(stats)},
                          make()).named_parameters())
    for name, p in port.named_parameters():
        assert_grads_close(_grad_or_zero(p), want[name].detach().numpy(),
                           name)
    if train:
        new_stats = dict(from_flax({"params": _np(params),
                                    "batch_stats": _np(new["batch_stats"])},
                                   make()).named_buffers())
        for name, buf in port.named_buffers():
            np.testing.assert_allclose(buf.numpy(), new_stats[name].numpy(),
                                       err_msg=name, **MODEL_TOL)
    return port


# ------------------------------------------------------------------ RWPE

def test_rwpe_equals_jax_exactly():
    """The three graphs (an isolated node: a zero row of D^-1 A), a graph
    with a self loop and a single edgeless node, at 1, 6 and 16 steps."""
    jg, tg = lpe_graphs(jbatch), lpe_graphs(tbatch)
    for pkg, graphs in ((jbatch, jg), (tbatch, tg)):
        graphs.append(pkg.Graph(x=np.zeros((4, 1), np.int32),
                                edge_index=np.array([[0, 1, 1, 2, 3],
                                                     [1, 0, 2, 1, 3]])))
        graphs.append(pkg.Graph(x=np.zeros((1, 1), np.int32),
                                edge_index=np.zeros((2, 0), np.int64)))
    for a, b in zip(jg, tg):
        for dim in (1, POS_DIM, 16):
            want, got = jrwpe(a, dim), trwpe(b, dim)
            assert got.dtype == np.float32 and got.shape == (a.num_nodes,
                                                             dim)
            assert np.array_equal(got, want)
    assert np.all(trwpe(tg[-1], 4) == 0)


# ------------------------------------------------------------- attention

@pytest.mark.parametrize("full_graph,typed,adaptive", [
    (True, True, False), (True, True, True), (True, False, True),
    (False, True, False), (False, False, True)])
def test_lspe_attention_matches_jax(full_graph, typed, adaptive):
    """LSPEAttention on the full and the sparse graph, typed bonds and the
    dense edge field, with and without the adaptive edge kernel (inert on
    the sparse graph, as in JAX): outputs, attention, structure and the
    gradients of the parameters and of x."""
    jb, tb = lspe_batches()
    mask = np.asarray(jb.node_mask)
    rng = np.random.default_rng(11)
    x = rng.standard_normal((3, N_MAX, 12)).astype(np.float32) \
        * mask[..., None]
    table = rng.standard_normal((4, 8)).astype(np.float32)
    field = table[np.asarray(jb.edge_type)]
    jmod = jlspe.LSPEAttention(out_dim=3, num_heads=4, full_graph=full_graph,
                               adaptive_edge_pe=adaptive)
    ekw = (dict(e_table=jnp.asarray(table),
                edge_ids=jnp.asarray(jb.edge_type)) if typed else {})
    e_emb = None if typed else jnp.asarray(field)
    args = (e_emb, jnp.asarray(jb.adj), jnp.asarray(mask),
            jnp.asarray(jb.pe))
    variables = random_variables(jmod, jnp.asarray(x), *args, **ekw)
    w = rng.standard_normal((3, N_MAX, 12)).astype(np.float32)

    def loss(p, xx):
        out, attn, struct = jmod.apply({"params": p}, xx, *args, **ekw)
        return (out * jnp.asarray(w)).sum(), (out, attn, struct)

    (_, want), (jgrads, jdx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(variables["params"],
                                             jnp.asarray(x))
    make = lambda: tlspe.LSPEAttention(12, 3, 4, 8, full_graph, adaptive)
    port = from_flax(variables, make())
    tx = torch.from_numpy(x).requires_grad_()
    tkw = (dict(e_table=torch.from_numpy(table), edge_ids=tb.edge_type)
           if typed else dict(e_emb=torch.from_numpy(field)))
    got = port(tx, tb.adj, tb.node_mask, tb.pe, **tkw)
    for g, wnt in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(wnt),
                                   **MODEL_TOL)
    (got[0] * torch.from_numpy(w)).sum().backward()
    assert_grads_close(tx.grad.numpy(), np.asarray(jdx), "x")
    grads = dict(from_flax({"params": _np(jgrads)}, make())
                 .named_parameters())
    for name, p in port.named_parameters():
        assert_grads_close(p.grad.numpy(), grads[name].detach().numpy(),
                           name)
    assert hasattr(port, "Q_2") == full_graph


# ---------------------------------------------------------------- nets

@pytest.mark.parametrize("opts,float_x", [
    (dict(adaptive_edge_pe=True, readout="sum"), 0),
    (dict(spectra=False, adaptive_edge_pe=True, readout="max"), 0),
    (dict(typed_edges=False, readout="mean", filter_order=3), 0),
    (dict(spectra=False, full_graph=False, typed_edges=False), 0),
    (dict(node_level=True, n_out=3, adaptive_edge_pe=True,
          layer_norm=True), 0),
    (dict(pe_init="no_pe", residual=False, out_dim=12), 0),
    (dict(categorical_input=False, readout="sum"), 5),
], ids=["spectra-adaptive-sum", "plain-adaptive-max", "field-mean",
        "plain-sparse-field", "node-level-ln", "no-pe-narrow-no-residual",
        "float-input"])
def test_graphit_spectra_net_matches_jax(opts, float_x):
    """GraphiTSpectraNet with the spectral filter on and off, typed bonds
    and the dense edge field, the adaptive edge kernel, the full and the
    sparse graph, the per-node readout with layer norm, pe_init no_pe
    (p zero, no p_out / Whp), a last layer narrower than the hidden width,
    float node features; each readout."""
    kw = dict(BASE, **opts)
    jb, tb = lspe_batches(float_x=float_x)
    port_kw = dict(kw, in_feat_dim=float_x) if float_x else kw
    port = check_model(jlspe.GraphiTSpectraNet(**kw),
                       tlspe.GraphiTSpectraNet, port_kw, jb, tb)
    spectra = opts.get("spectra", True)
    assert all(hasattr(layer, "cheb_weight") == spectra
               for layer in port.layers)
    assert hasattr(port, "Whp") == (opts.get("pe_init") != "no_pe")
    assert port.typed_edges == opts.get("typed_edges", True)


def test_graphit_spectra_net_trains_like_jax():
    """Train mode at dropout 0: batch statistics in every norm, and their
    running updates."""
    jb, tb = lspe_batches()
    kw = dict(BASE, adaptive_edge_pe=True)
    check_model(jlspe.GraphiTSpectraNet(**kw), tlspe.GraphiTSpectraNet, kw,
                jb, tb, train=True)


def test_graphit_lapeig_loss_raises_like_jax():
    _, tb = lspe_batches()
    model = tlspe.GraphiTSpectraNet(**BASE, use_lapeig_loss=True,
                                    device="cpu")
    with pytest.raises(NotImplementedError, match="use_lapeig_loss"):
        model(tb)
    with pytest.raises(ValueError, match="pe_init"):
        tlspe.GraphiTSpectraNet(**dict(BASE, pe_init="rwse"), device="cpu")


def _init_gamma(kw):
    """gamma at its init value (the random draw is near 0, where the
    clamp's flat side would hide its gradient)."""
    def set_gamma(params):
        params["gamma"] = np.float32(kw.get("gamma", 1e-5))
    return set_gamma


@pytest.mark.parametrize("opts", [
    dict(gamma=0.1, readout="sum"),
    dict(gamma=0.3, readout="max", layer_norm=True),
    dict(full_graph=False, readout="mean"),
    dict(gamma=0.2, pe_init="no_pe", out_dim=12, residual=False),
], ids=["sum", "max-ln", "sparse", "no-pe-narrow"])
def test_san_lspe_net_matches_jax(opts):
    """SANLSPENet: its learned gamma (clamped to [0, 1] at use) reaches
    every layer's attention, and its gradient flows through the clamp and
    is held like every other; on the sparse graph gamma is unused."""
    kw = dict(BASE, **opts)
    jb, tb = lspe_batches()
    port = check_model(jsan_lspe.SANLSPENet(**kw), tsan_lspe.SANLSPENet, kw,
                       jb, tb, set_params=_init_gamma(kw))
    assert port.gamma.shape == ()
    if kw.get("full_graph", True):
        assert float(port.gamma.grad.abs()) > 0
    else:
        assert port.gamma.grad is None


def test_san_lspe_net_trains_like_jax():
    jb, tb = lspe_batches()
    kw = dict(BASE, gamma=0.1)
    check_model(jsan_lspe.SANLSPENet(**kw), tsan_lspe.SANLSPENet, kw, jb, tb,
                train=True, set_params=_init_gamma(kw))


def test_san_lspe_gamma_is_clamped_at_use():
    """A gamma past 1 acts as 1 and takes no gradient (the clamp's
    flat side); the LPE nets' static gamma is untouched."""
    _, tb = lspe_batches()
    model = tsan_lspe.SANLSPENet(**BASE, device="cpu").eval()
    with torch.no_grad():
        model.gamma.fill_(1.0)
    at_one = model(tb)
    with torch.no_grad():
        model.gamma.fill_(4.0)
    out = model(tb)
    assert torch.equal(out, at_one)
    out.sum().backward()
    assert float(model.gamma.grad) == 0.0


def test_lspe_dropout_is_seeded_and_train_only():
    """Layer and input dropout 0.2: one seed of the model's generator
    gives one output, another seed another; eval draws no seed."""
    _, tb = lspe_batches()
    for cls in (tlspe.GraphiTSpectraNet, tsan_lspe.SANLSPENet):
        model = cls(**BASE, dropout=0.2, in_feat_dropout=0.2,
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
