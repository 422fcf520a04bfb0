"""The port's GCKN family (`feta_tmlr_tpu_torch/gckn/`) on the CPU against
the JAX package's `gckn/`, on the same numpy inputs: path enumeration (the
native build from `native/pathenum.cpp`, the Python twin and JAX's) and
`build_path_batch` bit for bit; the path convolution and pooling in every
pooling, the matrix inverse square root in float64 and the path layer in
both modes with gradients, within float32 rounding of the sums' order
(TOL; the eigh-based lintrans LINTRANS_TOL); k-means centres bit for bit
from the same seed (the numpy loop) and the torch loop against JAX's from
the same start; the encoder's codes as PE, the supervised net's logits and
gradients, the L-BFGS head and the exact path kernels. Small inputs: paths
of at most 4 nodes, at most 8 graphs of at most 12 nodes, hidden at most 8.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from feta_tmlr_tpu.data import batch as jbatch
from feta_tmlr_tpu.data.synthetic import random_graph_dataset
from feta_tmlr_tpu.gckn import kmeans as jkm
from feta_tmlr_tpu.gckn import layer as jlayer
from feta_tmlr_tpu.gckn import models as jmodels
from feta_tmlr_tpu.gckn import ops as jops
from feta_tmlr_tpu.gckn import path_kernel as jpk
from feta_tmlr_tpu.gckn import pathenum as jenum
from feta_tmlr_tpu.gckn import paths as jpaths
from feta_tmlr_tpu.gckn.linear import LinearClassifier as JLinear
from feta_tmlr_tpu_torch.convert import (
    gckn_supervised_from_jax,
    path_layers_from_jax,
)
from feta_tmlr_tpu_torch.data import batch as tbatch
from feta_tmlr_tpu_torch.gckn import kmeans as tkm
from feta_tmlr_tpu_torch.gckn import layer as tlayer
from feta_tmlr_tpu_torch.gckn import models as tmodels
from feta_tmlr_tpu_torch.gckn import ops as tops
from feta_tmlr_tpu_torch.gckn import path_kernel as tpk
from feta_tmlr_tpu_torch.gckn import pathenum as tenum
from feta_tmlr_tpu_torch.gckn import paths as tpaths
from feta_tmlr_tpu_torch.gckn.linear import LinearClassifier as TLinear
from feta_tmlr_tpu_torch.ops.kernels import host_build

TOL = dict(rtol=1e-4, atol=1e-5)
LINTRANS_TOL = dict(rtol=2e-3, atol=2e-4)
FIT_TOL = dict(rtol=1e-2, atol=3e-3)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Many small torch ops: one intra-op thread each, where the suite's
    parallel workers would otherwise oversubscribe the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _graphs(seed=0, n_graphs=6, n_features=5):
    """(JAX graphs, the port's graphs of the same arrays): 6-12 nodes."""
    jg = random_graph_dataset(seed=seed, n_graphs=n_graphs, min_nodes=6,
                              max_nodes=12, n_features=n_features,
                              edge_prob=0.3)
    tg = [tbatch.Graph(x=g.x.copy(), edge_index=g.edge_index.copy(), y=g.y)
          for g in jg]
    return jg, tg


def _assert_batch_equal(tb, jb):
    for f in dataclasses.fields(jb):
        a, b = getattr(tb, f.name), getattr(jb, f.name)
        if isinstance(b, list):
            assert len(a) == len(b), f.name
            for x, y in zip(a, b):
                assert x.dtype == y.dtype and np.array_equal(x, y), f.name
        elif isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and np.array_equal(a, b), f.name
        else:
            assert a == b, f.name


# --------------------------------------------------------------- enumeration

@pytest.mark.parametrize("kind", ["paths", "walks"])
def test_enumeration_native_python_and_jax_bit_equal(kind):
    """The library built from native/pathenum.cpp into build/, the Python
    twin and the JAX package's enumerator: the same rows in the same order
    and the same counts."""
    jg, _ = _graphs(1, n_graphs=4)
    assert host_build.lib_path("pathenum").parent.name == "build"
    for g in jg:
        n = g.num_nodes
        runs = [getattr(tenum, f"enumerate_{kind}")(g.edge_index, n, 4),
                getattr(tenum, f"enumerate_{kind}")(g.edge_index, n, 4,
                                                    impl="python"),
                getattr(jenum, f"enumerate_{kind}")(g.edge_index, n, 4),
                getattr(jenum, f"enumerate_{kind}_py")(g.edge_index, n, 4)]
        for paths, counts in runs[1:]:
            assert np.array_equal(counts, runs[0][1])
            for p, q in zip(paths, runs[0][0]):
                assert p.dtype == q.dtype == np.int32
                assert np.array_equal(p, q)
    assert host_build.lib_path("pathenum").exists()
    with pytest.raises(ValueError, match="impl"):
        tenum.enumerate_paths(jg[0].edge_index, jg[0].num_nodes, 2,
                              impl="cython")


def test_native_build_failure_raises(monkeypatch, tmp_path):
    """No compiler: the build raises; nothing falls back to the twin."""
    monkeypatch.setattr(host_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(host_build, "_libs", {})
    monkeypatch.setattr(host_build.shutil, "which", lambda _: None)
    monkeypatch.delenv("CXX", raising=False)
    jg, _ = _graphs(1, n_graphs=1)
    with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
        tenum.enumerate_paths(jg[0].edge_index, jg[0].num_nodes, 3)


@pytest.mark.parametrize("pad", [True, False])
def test_build_path_batch_bit_equal(pad):
    jg, tg = _graphs(2)
    _assert_batch_equal(tpaths.build_path_batch(tg, 4, pad=pad),
                        jpaths.build_path_batch(jg, 4, pad=pad))
    _assert_batch_equal(tpaths.build_path_batch(tg, 3, impl="python"),
                        jpaths.build_path_batch(jg, 3))


# --------------------------------------------------------------------- ops

def _vjp_jax(fn, *args, cot):
    """fn's output and the cotangent's pullback, in one jitted call."""
    @jax.jit
    def run(args, cot):
        out, vjp = jax.vjp(fn, *args)
        return out, vjp(cot)

    out, grads = run(tuple(jnp.asarray(a) for a in args), jnp.asarray(cot))
    return np.asarray(out), [np.asarray(g) for g in grads]


def _vjp_torch(fn, *args, cot):
    ts = [torch.tensor(a, requires_grad=True) for a in args]
    out = fn(*ts)
    out.backward(torch.from_numpy(np.asarray(cot)))
    return out.detach().numpy(), [t.grad.numpy() for t in ts]


@pytest.mark.parametrize("pooling", ["mean", "sum", "max"])
def test_path_conv_agg_matches_jax(pooling):
    """Every path size's gather-mean -> kappa -> pooling, output and
    gradient; the port's blocked run (blocks of 7 rows, cut between
    segments) gives its one-shot run's output bit for bit (a gradient row
    sums over the blocks that read it, so there only within TOL)."""
    jg, tg = _graphs(3)
    jb = jpaths.build_path_batch(jg, 4)
    tb = tpaths.build_path_batch(tg, 4)
    rng = np.random.default_rng(0)
    v1 = jb.n_nodes + 1
    feats = rng.standard_normal((v1, 4, 6)).astype(np.float32) * 0.3
    cot = rng.standard_normal((v1, 6)).astype(np.float32)
    for s in (1, 4):
        pi, si, pm = (tb.path_indices[s - 1], tb.segment_ids[s - 1],
                      tb.path_mask[s - 1])
        want, (want_g,) = _vjp_jax(
            lambda f: jops.path_conv_agg(
                f, jnp.asarray(pi), jnp.asarray(si), v1, pooling,
                lambda x: jops.exp_kernel(x, 4.0), jnp.asarray(pm)),
            feats, cot=cot)
        tpi, tsi, tpm = (torch.from_numpy(a).long() if a.dtype != bool
                         else torch.from_numpy(a) for a in (pi, si, pm))
        outs = []
        for blocks in (None, tops.path_blocks(si, v1, 7)):
            got, (got_g,) = _vjp_torch(
                lambda f: tops.path_conv_agg(
                    f, tpi, tsi, v1, pooling,
                    lambda x: tops.exp_kernel(x, 4.0), tpm, blocks=blocks),
                feats, cot=cot)
            np.testing.assert_allclose(got, want, **TOL)
            np.testing.assert_allclose(got_g, want_g, **TOL)
            outs.append((got, got_g))
        assert np.array_equal(outs[0][0], outs[1][0])


def test_path_blocks_cover_rows_and_segments():
    ids = np.array([0, 0, 0, 2, 2, 3, 3, 3, 3, 3, 5, 9, 9, 9])
    blocks = tops.path_blocks(ids, 10, 4)
    assert blocks[0][0] == 0 and blocks[-1][1] == len(ids)
    assert blocks[0][2] == 0 and blocks[-1][3] == 10
    for (r0, r1, g0, g1), nxt in zip(blocks, blocks[1:] + [None]):
        assert r0 < r1 and g0 < g1
        assert ids[r0:r1].min() >= g0 and ids[r0:r1].max() < g1
        if nxt is not None:
            assert (r1, g1) == (nxt[0], nxt[2])
    # the 5-row segment 3 gets a block of its own
    assert (5, 10, 3, 5) in blocks


def test_matrix_inverse_sqrt_float64_with_gradient():
    """Float64 on both sides: positive definite matrices, output and
    gradient; a matrix with a negative eigenvalue (clamped at 0), output
    only: there JAX's gradient is NaN (sqrt'(0) * 0), torch's finite (the
    clamp's backward selects 0)."""
    rng = np.random.default_rng(4)
    a = rng.standard_normal((2, 6, 6))
    mats = a @ a.transpose(0, 2, 1) + 0.1 * np.eye(6)
    clamped = np.diag([1.0, 0.5, 1e-3, -1e-9, 2.0, 3.0])[None]
    cot = rng.standard_normal(mats.shape)
    with jax.enable_x64(True):
        want, (want_g,) = _vjp_jax(jops.matrix_inverse_sqrt, mats, cot=cot)
        want_c, (want_cg,) = _vjp_jax(jops.matrix_inverse_sqrt, clamped,
                                      cot=cot[:1])
    got, (got_g,) = _vjp_torch(tops.matrix_inverse_sqrt, mats, cot=cot)
    got_c, (got_cg,) = _vjp_torch(tops.matrix_inverse_sqrt, clamped,
                                  cot=cot[:1])
    assert got.dtype == np.float64
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-11)
    np.testing.assert_allclose(got_g, want_g, rtol=1e-7, atol=1e-9)
    np.testing.assert_allclose(got_c, want_c, rtol=1e-9, atol=1e-11)
    assert np.isnan(want_cg).any() and np.isfinite(got_cg).all()
    x = rng.standard_normal((5, 3)).astype(np.float32)
    x[2] = 0.0
    np.testing.assert_allclose(tops.normalize_rows(torch.from_numpy(x)),
                               np.asarray(jops.normalize_rows(x)), **TOL)


# -------------------------------------------------------------- path layer

def _layer_pair(seed, in_size, hidden, path_size, aggregation, pooling):
    w = np.asarray(jax.random.uniform(
        jax.random.key(seed), (path_size, hidden, in_size), minval=-0.5,
        maxval=0.5))
    kw = dict(path_size=path_size, kernel_arg=0.6, pooling=pooling,
              aggregation=aggregation)
    return (jlayer.PathLayerParams(weight=jnp.asarray(w), **kw),
            tlayer.PathLayerParams(weight=torch.tensor(w), **kw), w)


@pytest.mark.parametrize("aggregation", [False, True],
                         ids=["plain", "aggregation"])
@pytest.mark.parametrize("stacked", [False, True], ids=["q1", "q3"])
def test_path_layer_forward_matches_jax(aggregation, stacked):
    """Output and the gradients to the anchors and to the input, for [V+1,
    F] and Q-stacked [V+1, Q, F] inputs; the lintrans alone within
    LINTRANS_TOL (a float32 eigh)."""
    jg, tg = _graphs(5)
    jb = jpaths.build_path_batch(jg, 3)
    tb = tpaths.build_path_batch(tg, 3)
    jp, tp, w = _layer_pair(1, 5, 8, 3, aggregation, "mean")
    rng = np.random.default_rng(1)
    shape = (jb.n_nodes + 1, 3, 5) if stacked else (jb.n_nodes + 1, 5)
    feats = rng.standard_normal(shape).astype(np.float32)
    feats[-1] = 0.0                                   # the dummy row
    q = 3 if stacked else 1
    out_q = q * 3 if aggregation else q
    cot = rng.standard_normal((jb.n_nodes + 1, out_q, 8)).astype(np.float32)
    want, want_g = _vjp_jax(
        lambda f, ww: jlayer.path_layer_forward(
            dataclasses.replace(jp, weight=ww), f, jb), feats, w, cot=cot)
    got, got_g = _vjp_torch(
        lambda f, ww: tlayer.path_layer_forward(tp, f, tb, weight=ww),
        feats, w.astype(np.float32), cot=cot)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-4 * scale)
    # the dummy row's features are 0: JAX's gradient of their norm is
    # NaN there, torch's 0 (no path reads the row's gradient)
    assert np.isnan(want_g[0][-1]).all() and (got_g[0][-1] == 0).all()
    for g, h in ((got_g[0][:-1], want_g[0][:-1]), (got_g[1], want_g[1])):
        np.testing.assert_allclose(g, h, rtol=2e-3,
                                   atol=2e-4 * np.abs(h).max())
    np.testing.assert_allclose(tlayer.compute_lintrans(tp).numpy(),
                               np.asarray(jlayer.compute_lintrans(jp)),
                               **LINTRANS_TOL)


def test_sample_paths_bit_equal():
    jg, tg = _graphs(6)
    jb = jpaths.build_path_batch(jg, 3)
    tb = tpaths.build_path_batch(tg, 3)
    for s in (1, 3):
        jp, tp, _ = _layer_pair(0, 5, 4, s, False, "mean")
        for feats in (jb.features, np.stack([jb.features] * 2, 1)):
            want = jlayer.sample_paths(jp, jnp.asarray(feats), jb, 50, 3)
            got = tlayer.sample_paths(tp, torch.from_numpy(feats), tb, 50, 3)
            assert got.dtype == want.dtype and np.array_equal(got, want)


# ------------------------------------------------------------------ k-means

def _kmeans_samples(seed=0, n=300):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, 3, 5)).astype(np.float32)


def test_numpy_kmeans_bit_equal_to_jax():
    x = _kmeans_samples()
    rng_j, rng_t = np.random.default_rng(3), np.random.default_rng(3)
    x64 = jkm._normalize(x.astype(np.float64))
    assert np.array_equal(tkm.kmeans_plus_plus(x64, 8, rng_t),
                          jkm.kmeans_plus_plus(x64, 8, rng_j))
    for k in (8, 40):
        got = tkm.spherical_kmeans(x, k, seed=1)
        want = jkm.spherical_kmeans(x, k, seed=1)
        assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("case", ["regular", "empty_clusters"])
def test_torch_kmeans_matches_jax_kmeans(case):
    """From the same start: the torch Lloyd loop against the JAX one; a
    start with duplicated centres empties clusters, which both refill
    together from the worst-represented points."""
    x = _kmeans_samples(1)
    x64 = jkm._normalize(x.astype(np.float64))
    if case == "regular":
        init = jkm.kmeans_plus_plus(x64, 6, np.random.default_rng(0))
    else:
        init = np.repeat(x64[:2], 3, axis=0)          # 4 of 6 start empty
    want = jkm.spherical_kmeans_jax(x, 6, init_centers=init)
    got = tkm.spherical_kmeans_torch(x, 6, init_centers=init, device="cpu")
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_unsup_train_layer_matches_jax():
    x = _kmeans_samples(2, n=200)
    jp, tp, _ = _layer_pair(0, 5, 4, 3, False, "mean")
    want = np.asarray(jlayer.unsup_train_layer(jp, x, seed=2).weight)
    got = tlayer.unsup_train_layer(tp, x, seed=2).weight.numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    got_t = tlayer.unsup_train_layer(tp, x, seed=2, kmeans_impl="torch",
                                     device="cpu").weight.numpy()
    want_j = np.asarray(jlayer.unsup_train_layer(jp, x, seed=2,
                                                 use_jax=True).weight)
    np.testing.assert_allclose(got_t, want_j, rtol=1e-4, atol=1e-5)


# --------------------------------------------------------------- the models

@pytest.mark.parametrize("aggregation,pooling", [(False, "sum"),
                                                 (True, "mean"),
                                                 (False, "max")])
def test_gckn_encode_as_pe_matches_jax(aggregation, pooling):
    """k-means (numpy, the same draws), the encode on the CPU and the
    standardisation: the codes attached as lap_pe."""
    jg, tg = _graphs(7, n_graphs=8)
    kw = dict(dim=6, path_size=3, n_sampling_paths=400,
              aggregation=aggregation, kernel_arg=0.6, pooling=pooling,
              seed=1)
    assert jmodels.gckn_encode_as_pe(jg, **kw) == \
        tmodels.gckn_encode_as_pe(tg, device="cpu", **kw)
    for j, t in zip(jg, tg):
        assert t.lap_pe.dtype == np.float32
        np.testing.assert_allclose(t.lap_pe, j.lap_pe, rtol=1e-3, atol=1e-3)


def test_gckn_feature_two_layers_matches_jax():
    """A two-layer encoder (paths of 2 then 3 nodes, aggregation, hidden 4
    and 6) with the same anchors (`path_layers_from_jax`): the codes; then
    both pretrained by k-means, layer 2 from layer 1's output, and the
    codes again; the port's chunked encode equal to its one-batch one."""
    jg, tg = _graphs(8, n_graphs=6)
    kw = dict(input_size=5, hidden_sizes=[4, 6], path_sizes=[2, 3],
              kernel_args=[0.5, 0.6], pooling="mean", aggregation=True)
    jf = jmodels.GCKNFeature.create(seed=0, **kw)
    tf = tmodels.GCKNFeature.create(seed=0, **kw)
    assert tf.output_dim == jf.output_dim == 2 * 3 * 6
    path_layers_from_jax([np.asarray(l.weight) for l in jf.layers], tf)
    cpu = jax.devices("cpu")[0]
    for step in ("init", "trained"):
        want = jf.encode(jg, device=cpu)
        got = tf.encode(tg, device="cpu")
        for a, b in zip(got, want):
            np.testing.assert_allclose(a, b, rtol=2e-3,
                                       atol=2e-4 * np.abs(b).max())
        if step == "init":
            jf.unsup_train(jg, 300, seed=0, device=cpu)
            tf.unsup_train(tg, 300, seed=0, device="cpu")
    chunked = tf.encode(tg, device="cpu", chunk_graphs=4)
    for a, b in zip(chunked, got):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)


def test_gckn_supervised_matches_jax():
    """GCKNSupervised (k-means init, the same numpy classifier draws) with
    JAX's parameters loaded by `gckn_supervised_from_jax`: logits in
    training mode and with frozen statistics, and every parameter's
    gradient of a random projection of the logits."""
    jg, tg = _graphs(9, n_graphs=8)
    kw = dict(input_size=5, hidden_sizes=[6], path_sizes=[3], n_classes=3,
              kernel_args=0.5, pooling="sum", seed=2)
    jm = jmodels.GCKNSupervised(**kw)
    tm = tmodels.GCKNSupervised(device="cpu", **kw)
    assert np.array_equal(tm.classifier_w.detach().numpy(),
                          np.asarray(jm.init_params["classifier_w"]))
    jb = jm.unsup_init(jg, 300, seed=2)
    tb = tm.unsup_init(tg, 300, seed=2)
    np.testing.assert_allclose(tm.layer_0_weight.detach().numpy(),
                               np.asarray(jm.init_params["layer_0_weight"]),
                               rtol=1e-6, atol=1e-7)
    params = {k: np.asarray(v) for k, v in jm.init_params.items()}
    params["bn_scale"] = np.linspace(0.5, 1.5, 6).astype(np.float32)
    gckn_supervised_from_jax(params, tm)
    cot = np.random.default_rng(0).standard_normal((8, 3)).astype(
        np.float32)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    want, (want_g,) = jax.jit(lambda p, c: (lambda o, f: (o, f(c)))(
        *jax.vjp(lambda q: jm.apply(q, jb), p)))(jparams, jnp.asarray(cot))
    out = tm(tb)
    out.backward(torch.from_numpy(cot))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               rtol=1e-3, atol=1e-4)
    for name, p in tm.named_parameters():
        g = np.asarray(want_g[name])
        np.testing.assert_allclose(p.grad.numpy(), g, rtol=2e-3,
                                   atol=2e-4 * max(np.abs(g).max(), 1e-6),
                                   err_msg=name)
    stats = tm.compute_bn_stats(tb)
    with torch.no_grad():
        frozen = tm(tb, stats).numpy()
    want_frozen = jax.jit(lambda p: jm.apply(
        p, jb, jm.compute_bn_stats(p, jb)))(jparams)
    np.testing.assert_allclose(frozen, np.asarray(want_frozen), rtol=1e-3,
                               atol=1e-4)
    with pytest.raises(KeyError):
        gckn_supervised_from_jax({k: v for k, v in params.items()
                                  if k != "bn_bias"}, tm)


@pytest.mark.parametrize("loss,n_out", [("ce", 3), ("hinge", 3),
                                        ("ce", 1)])
def test_linear_classifier_fit_matches_jax(loss, n_out):
    """The L-BFGS fit (alpha 0.5: a strongly convex problem, one optimum):
    the port's float64 objective against JAX's float32 one, whose float32
    gradient stops its iterations ~1e-3 from the optimum: the fitted
    weights, decision function and probabilities within FIT_TOL."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((60, 7)).astype(np.float32)
    y = rng.integers(0, max(n_out, 2), 60)
    want = JLinear(7, n_out, alpha=0.5, loss=loss).fit(x, y)
    got = TLinear(7, n_out, alpha=0.5, loss=loss).fit(x, y)
    np.testing.assert_allclose(got.weight, want.weight, **FIT_TOL)
    np.testing.assert_allclose(got.bias, want.bias, **FIT_TOL)
    np.testing.assert_allclose(got.decision_function(x),
                               want.decision_function(x), **FIT_TOL)
    np.testing.assert_allclose(got.predict_proba(x), want.predict_proba(x),
                               **FIT_TOL)


def test_unsup_train_classifier_matches_jax():
    jg, tg = _graphs(10, n_graphs=8)
    kw = dict(input_size=5, hidden_sizes=[4], path_sizes=[2], n_classes=2,
              kernel_args=0.5, pooling="mean", seed=0)
    jm = jmodels.GCKNSupervised(**kw)
    tm = tmodels.GCKNSupervised(device="cpu", **kw)
    jb = jm.unsup_init(jg, 200)
    tb = tm.unsup_init(tg, 200)
    gckn_supervised_from_jax({k: np.asarray(v)
                              for k, v in jm.init_params.items()}, tm)
    labels = np.array([int(g.y) for g in jg])
    want = jm.unsup_train_classifier(dict(jm.init_params), jb, labels,
                                     alpha=1.0)
    tm.unsup_train_classifier(tb, labels, alpha=1.0)
    np.testing.assert_allclose(tm.classifier_w.detach().numpy(),
                               np.asarray(want["classifier_w"]), rtol=1e-3,
                               atol=1e-3)


# -------------------------------------------------------------- path kernel

def _kernel_graphs(seed=0, sizes=(4, 5, 6, 2)):
    rng = np.random.default_rng(seed)
    out = []
    for n in sizes:
        edges = {(i, i + 1) for i in range(n - 1)}
        for _ in range(2):
            a, b = rng.integers(0, n, 2)
            if a != b:
                edges.add((min(a, b), max(a, b)))
        ei = np.array([[a, b] for a, b in edges]
                      + [[b, a] for a, b in edges]).T
        x = rng.normal(size=(n, 3))
        out.append((x / np.linalg.norm(x, axis=1, keepdims=True), ei))
    return out


@pytest.mark.parametrize("normalize,cum", [(False, False), (True, True),
                                           (False, True)])
def test_path_kernel_gram_and_pair_match_jax(normalize, cum):
    """The Gram matrix (the 2-node graph has no paths of 3 or 4 nodes: the
    reference's empty-length quirk) and the per-length pair values."""
    graphs = _kernel_graphs()
    kw = dict(coef=1.5, normalize=normalize, cum=cum, sigma=0.8)
    np.testing.assert_allclose(
        tpk.path_kernel_gram(graphs, 4, device="cpu", **kw),
        jpk.path_kernel_gram(graphs, 4, **kw), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(
        tpk.path_kernel_pair(graphs[0], graphs[2], 3, sigma=0.7,
                             device="cpu"),
        jpk.path_kernel_pair(graphs[0], graphs[2], 3, sigma=0.7),
        rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("reference_semantics", [True, False])
def test_path_filter_response_matches_jax(reference_semantics):
    graphs = _kernel_graphs(1, sizes=(7, 2))
    filters = np.random.default_rng(2).standard_normal((3, 4, 3))
    for g in graphs:
        got = tpk.path_filter_response(
            g, filters, sigma=0.6, reference_semantics=reference_semantics,
            device="cpu")
        want = jpk.path_filter_response(
            g, filters, sigma=0.6, reference_semantics=reference_semantics)
        assert tuple(got.shape) == tuple(want.shape) == (3, 4)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-6)


def test_gckn_entry_points_default_to_cuda(monkeypatch):
    """Without a card the encoder, the supervised net and the path kernel
    raise unless the CPU is asked for."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tg = _graphs(0, n_graphs=2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tmodels.gckn_encode_as_pe(tg, dim=4, path_size=2,
                                  n_sampling_paths=50)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tmodels.GCKNSupervised(5, [4], [2], 2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tpk.path_kernel_gram(_kernel_graphs(), 2)
