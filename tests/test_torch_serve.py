"""The port's serving layer vs the JAX package, on the CPU: `Predictor`
(padded tail, window of chunks in flight, buckets, warmup), `bucketize`,
`DynamicBatcher`, the HTTP endpoint and the serving CLI.

`Predictor` is held to the JAX `Predictor` on SAN_NodeSpectra (mean, sum
and max readouts) and on the GraphiT-FeTA ZINC model with the same
weights (`convert.from_flax`, biases and batch-norm statistics perturbed
away from their init), 10 graphs at max_batch 4 so the tail chunk is
padded: logits within 1e-5 (absolute and relative; f32 with sums in
other orders on the two sides). Everything the port computes twice from
the same inputs is held exactly.
"""

import functools
import json
import sys
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import jax

from feta_tmlr_tpu.data import batch as jbatch
from feta_tmlr_tpu.data.synthetic import zinc_categorical_dataset as j_zinc
from feta_tmlr_tpu.data.synthetic import zinc_like_dataset as j_zinc_like
from feta_tmlr_tpu.nn import models as jmodels
from feta_tmlr_tpu.nn import san as jsan
from feta_tmlr_tpu.pe import encodings as jpe
from feta_tmlr_tpu.pe.laplace import apply_laplace_decomp as j_eig
from feta_tmlr_tpu.serve import Predictor as JPredictor
from feta_tmlr_tpu.serve import bucketize as j_bucketize
from feta_tmlr_tpu_torch.convert import from_flax
from feta_tmlr_tpu_torch.data.batch import collate_graphs
from feta_tmlr_tpu_torch.data.synthetic import zinc_categorical_dataset as t_zinc
from feta_tmlr_tpu_torch.data.synthetic import zinc_like_dataset as t_zinc_like
from feta_tmlr_tpu_torch.nn import models as tmodels
from feta_tmlr_tpu_torch.nn import san as tsan
from feta_tmlr_tpu_torch.pe import encodings as tpe
from feta_tmlr_tpu_torch.pe.laplace import apply_laplace_decomp as t_eig
from feta_tmlr_tpu_torch.serve import WINDOW
from feta_tmlr_tpu_torch.serve import Predictor as TPredictor
from feta_tmlr_tpu_torch.serve import bucketize as t_bucketize
from feta_tmlr_tpu_torch.serve_batcher import DynamicBatcher
from feta_tmlr_tpu_torch.serve_http import _graph_from_json, start_background

SERVE_TOL = dict(rtol=1e-5, atol=1e-5)
M_FREQS = 6
SAN_CFG = dict(num_atom_type=28, num_bond_type=4, hidden_dim=16, out_dim=16,
               n_heads=2, n_layers=1, lpe_dim=4, lpe_heads=2, lpe_layers=1,
               filter_order=3)
ZINC_CFG = dict(in_size=28, nb_class=1, d_model=16, nb_heads=2,
                dim_feedforward=32, dropout=0.0, nb_layers=2, batch_norm=True,
                lap_pos_enc=True, lap_pos_enc_dim=4, filter_order=3)


def _perturb(variables, seed=11):
    rng = np.random.default_rng(seed)
    out = {"params": jax.tree.map(
        lambda p: np.asarray(p) + 0.05 * rng.standard_normal(
            p.shape).astype(np.float32), variables["params"])}
    out["batch_stats"] = jax.tree_util.tree_map_with_path(
        lambda path, a: (rng.random(a.shape) + 0.5 if path[-1].key == "var"
                         else 0.3 * rng.standard_normal(a.shape)
                         ).astype(np.float32),
        jax.tree.map(np.asarray, variables["batch_stats"]))
    return out


def _san_graphs(seed=1, n=10):
    jg, tg = j_zinc(seed=seed, n_graphs=n), t_zinc(seed=seed, n_graphs=n)
    j_eig(jg, M_FREQS)
    t_eig(tg, M_FREQS)
    return jg, tg


@functools.lru_cache(maxsize=None)
def _san_variables(n_max):
    jmodel = jsan.SANNodeSpectra(**SAN_CFG)
    jg, _ = _san_graphs(n=2)
    return jmodel, _perturb(jax.jit(jmodel.init)(
        jax.random.key(0), jbatch.collate_graphs(jg, max_nodes=n_max)))


def _san_pair(n_max, readout="mean"):
    """The JAX and port SAN models with one readout and the same weights
    (the readout adds no parameters, so every readout shares them)."""
    _, variables = _san_variables(n_max)
    jmodel = jsan.SANNodeSpectra(**SAN_CFG, readout=readout)
    port = from_flax(variables, tsan.SANNodeSpectra(**SAN_CFG, readout=readout,
                                                    device="cpu"))
    return jmodel, variables, port


def _zinc_graphs(n=10, n_max=24):
    keep = [i for i, g in enumerate(t_zinc_like(seed=0, n_graphs=40))
            if g.num_nodes <= n_max][:n]
    jg = [j_zinc_like(seed=0, n_graphs=40)[i] for i in keep]
    tg = [t_zinc_like(seed=0, n_graphs=40)[i] for i in keep]
    for enc in (jpe.DiffusionEncoding(beta=1.0), jpe.LapEncoding(4)):
        enc.apply_to(jg)
    for enc in (tpe.DiffusionEncoding(beta=1.0), tpe.LapEncoding(4)):
        enc.apply_to(tg)
    return jg, tg


@functools.lru_cache(maxsize=None)
def _zinc_variables(n_max):
    jg, _ = _zinc_graphs(n=2, n_max=n_max)
    jmodel = jmodels.DiffGraphTransformerGenGCN(**ZINC_CFG)
    return jmodel, _perturb(jax.jit(jmodel.init)(
        jax.random.key(0), jbatch.collate_graphs(jg, max_nodes=n_max)))


def _zinc_port(n_max=24):
    jg, tg = _zinc_graphs(n_max=n_max)
    jmodel, variables = _zinc_variables(n_max)
    port = from_flax(variables, tmodels.DiffGraphTransformerGenGCN(
        **ZINC_CFG, device="cpu"))
    return jmodel, variables, port, jg, tg


# ------------------------------------------------------------ Predictor

@pytest.mark.parametrize("readout", ["mean", "sum", "max"])
def test_predictor_matches_jax_on_san(readout):
    jg, tg = _san_graphs()
    n_max = 32
    jmodel, variables, port = _san_pair(n_max, readout)
    kw = dict(max_batch=4, collate_kwargs={"max_nodes": n_max})
    want = JPredictor(jmodel, variables=variables, **kw).predict(jg)
    pred = TPredictor(port, device="cpu", **kw)
    got = pred.predict(tg)
    assert got.shape == (10, 1) and len(tg) % 4
    np.testing.assert_allclose(got, np.asarray(want), **SERVE_TOL)
    assert pred.compile_stats()["shapes"] == [(4, n_max)]


def test_predictor_matches_jax_on_graphit_zinc():
    jmodel, variables, port, jg, tg = _zinc_port()
    kw = dict(max_batch=4, collate_kwargs={"max_nodes": 24})
    want = JPredictor(jmodel, variables=variables, **kw).predict(jg)
    got = TPredictor(port, device="cpu", **kw).predict(tg)
    assert got.shape == (10, 1)
    np.testing.assert_allclose(got, np.asarray(want), **SERVE_TOL)


def test_padded_tail_does_not_change_real_graphs():
    """Eval batch norm and rate-0 eigen-PE dropout: a graph's logits do
    not depend on what else is in its chunk."""
    _, tg = _san_graphs(seed=2)
    _, _, port = _san_pair(32)
    port.train()                 # the Predictor must switch to eval
    kw = dict(collate_kwargs={"max_nodes": 32})
    tail = TPredictor(port, device="cpu", max_batch=4, **kw).predict(tg)
    assert not port.training
    alone = np.concatenate([TPredictor(port, device="cpu", max_batch=1, **kw)
                            .predict([g]) for g in tg])
    np.testing.assert_allclose(tail, alone, rtol=1e-6, atol=1e-6)
    first = TPredictor(port, device="cpu", max_batch=4, **kw).predict(tg[8:])
    np.testing.assert_array_equal(first, tail[8:])


def test_window_of_chunks_matches_one_chunk_at_a_time():
    """12 chunks through the window of WINDOW chunks in flight give the
    logits of 12 single-chunk requests, bit for bit, graph- and
    node-level."""
    _, _, port, _, tg = _zinc_port()
    graphs = (tg * 3)[:23]                    # 12 chunks of 2, tail of 1
    pred = TPredictor(port, device="cpu", max_batch=2,
                      collate_kwargs={"max_nodes": 24})
    copies = []
    to_host = pred._to_host
    pred._to_host = lambda logits: copies.append(1) or to_host(logits)
    whole = pred.predict(graphs)
    assert len(copies) == 12 > WINDOW
    one = np.concatenate([pred.predict(graphs[i:i + 2])
                          for i in range(0, len(graphs), 2)])
    assert whole.shape == (23, 1)
    np.testing.assert_array_equal(whole, one)

    class NodeLevel(torch.nn.Module):          # per-node outputs [B, N, 2]
        def __init__(self):
            super().__init__()
            self.lin = torch.nn.Linear(28, 2)

        def forward(self, batch):
            return self.lin(batch.x) * batch.node_mask[..., None]

    node = TPredictor(NodeLevel(), device="cpu", max_batch=2,
                      node_level=True)
    ragged = node.predict(graphs)
    assert ragged.dtype == object and len(ragged) == 23
    for g, out, single in zip(graphs, ragged, (
            node.predict([g])[0] for g in graphs)):
        assert out.shape == (g.num_nodes, 2)
        np.testing.assert_array_equal(out, single)


def test_predictor_restores_trainer_checkpoint(tmp_path):
    from feta_tmlr_tpu_torch.train.trainer import TrainConfig, Trainer
    _, _, port, _, tg = _zinc_port()
    trainer = Trainer(port, TrainConfig(task="graph_reg", sign_flip=False))
    batches = [collate_graphs(tg[:5], max_nodes=24),
               collate_graphs(tg[5:], max_nodes=24)]
    trainer.fit(batches, epochs=2, ckpt_dir=str(tmp_path))
    want = TPredictor(port, device="cpu", max_batch=4,
                      collate_kwargs={"max_nodes": 24}).predict(tg)
    fresh = tmodels.DiffGraphTransformerGenGCN(**ZINC_CFG, seed=9,
                                               device="cpu")
    got = TPredictor(fresh, device="cpu", ckpt_dir=str(tmp_path),
                     max_batch=4,
                     collate_kwargs={"max_nodes": 24}).predict(tg)
    np.testing.assert_array_equal(got, want)


# ------------------------------------------------- bucketize and warmup

def test_bucketize_groups_as_jax():
    jg, tg = _san_graphs(seed=3, n=12)
    for buckets in (None, (12, 20, 28), (16,)):
        want = j_bucketize(jg, buckets)
        got = t_bucketize(tg, buckets)
        assert sorted(got) == sorted(want)
        tpos = {id(g): i for i, g in enumerate(tg)}
        jpos = {id(g): i for i, g in enumerate(jg)}
        for b in got:
            assert [tpos[id(g)] for g in got[b]] == \
                [jpos[id(g)] for g in want[b]]


class _Echo(torch.nn.Module):
    """Returns one number a graph: its node count, from the mask."""

    def forward(self, batch):
        return batch.node_mask.sum(1, keepdim=True).float()


@pytest.mark.parametrize("case", [
    dict(node_buckets=(16, 32)),
    dict(collate_kwargs={"max_nodes": 40}),
    dict(),
    dict(buckets=(8, 24, 64)),
])
def test_warmup_counts_as_jax(case):
    """warmup runs (and returns the count of) the shapes the JAX
    Predictor compiles for the same sample and settings."""
    case = dict(case)
    buckets = case.pop("buckets", None)
    jg, tg = _san_graphs(seed=4, n=2)
    jpred = JPredictor(jsan.SANNodeSpectra(**SAN_CFG), variables={},
                       max_batch=2, **case)
    jpred._compiled["fn"] = lambda variables, batch: batch.x   # no compile
    want = jpred.warmup(jg[0], buckets)
    tpred = TPredictor(_Echo(), device="cpu", max_batch=2, **case)
    got = tpred.warmup(tg[0], buckets)
    assert got == want > 0
    assert len(tpred.compile_stats()["shapes"]) == got


def test_warmup_serves_after_running_the_model():
    _, tg = _san_graphs(seed=5, n=6)
    _, _, port = _san_pair(32)
    pred = TPredictor(port, device="cpu", max_batch=4, node_buckets=(32, 48))
    assert pred.warmup(tg[0]) == 2
    assert pred.compile_stats()["shapes"] == [(4, 32), (4, 48)]
    out = pred.predict(tg)
    assert out.shape == (6, 1) and np.isfinite(out).all()
    assert pred.compile_stats()["buckets"] == (32, 48)


# ------------------------------------------------------------- batcher

@pytest.fixture
def fast_switch():
    """Threads switched every 10 us, so a lost update or a race shows."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        yield
    finally:
        sys.setswitchinterval(old)


def _exact_predictor():
    """One graph a chunk at one padded size: every graph's logits are
    computed alike however requests are merged."""
    _, _, port, _, tg = _zinc_port()
    return TPredictor(port, device="cpu", max_batch=1,
                      collate_kwargs={"max_nodes": 24}), tg


def test_batcher_gives_eight_concurrent_callers_their_own_logits(
        fast_switch):
    pred, tg = _exact_predictor()
    requests = [tg[i % len(tg): i % len(tg) + 1 + i % 3] for i in range(8)]
    want = [pred.predict(r) for r in requests]
    batcher = DynamicBatcher(pred, max_wait_ms=50.0, max_batch=16)
    results = [None] * 8
    barrier = threading.Barrier(8)

    def caller(i):
        barrier.wait()
        results[i] = batcher.predict(requests[i])

    threads = [threading.Thread(target=caller, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    batcher.close()
    for got, ref in zip(results, want):
        assert got is not None and got.shape == ref.shape
        np.testing.assert_array_equal(got, ref)
    with pytest.raises(RuntimeError, match="closed"):
        batcher.predict(requests[0])


def test_batcher_close_racing_predict_returns(fast_switch):
    pred, tg = _exact_predictor()
    batcher = DynamicBatcher(pred, max_wait_ms=1.0)
    outcomes = []
    stop = threading.Event()

    def caller():
        while not stop.is_set():
            try:
                outcomes.append(batcher.predict(tg[:1]).shape)
            except RuntimeError as e:
                outcomes.append(str(e))
                return

    threads = [threading.Thread(target=caller) for _ in range(4)]
    for t in threads:
        t.start()
    closer = threading.Thread(target=batcher.close)
    closer.start()
    closer.join(timeout=30)
    stop.set()
    for t in threads:
        t.join(timeout=30)
    assert not closer.is_alive()
    assert not any(t.is_alive() for t in threads)
    assert all(o == (1, 1) or "closed" in o for o in outcomes)


# ---------------------------------------------------------------- HTTP

def _post(port, path, payload, raw=None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=raw if raw is not None else json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=30) as r:
        return json.loads(r.read())


def _wire(g, flat=True):
    return {"x_int": (g.x.reshape(-1) if flat else g.x).tolist(),
            "edge_index": g.edge_index.tolist(),
            "edge_type": g.edge_type.tolist()}


def test_graph_from_json_matches_jax():
    from feta_tmlr_tpu.serve_http import _graph_from_json as j_from_json
    g = t_zinc(seed=0, n_graphs=1)[0]
    for flat in (True, False):
        got, want = _graph_from_json(_wire(g, flat)), j_from_json(_wire(g,
                                                                        flat))
        np.testing.assert_array_equal(got.x, want.x)
        assert got.x.dtype == want.x.dtype == np.int32
        assert got.x.shape == (g.num_nodes, 1)
        np.testing.assert_array_equal(got.edge_index, want.edge_index)
    np.testing.assert_array_equal(got.edge_type, g.edge_type)
    dense = {"x": [[0.5, 1.0]], "degree": [0.7]}
    got, want = _graph_from_json(dense), j_from_json(dense)
    np.testing.assert_array_equal(got.x, want.x)
    assert got.edge_index.shape == want.edge_index.shape == (2, 0)


def test_http_round_trip_matches_direct_predictor():
    _, tg = _san_graphs(seed=6, n=6)
    _, _, port = _san_pair(32)
    pred = TPredictor(port, device="cpu", max_batch=4,
                      collate_kwargs={"max_nodes": 32})
    srv, http_port = start_background(
        pred, preprocess=lambda gs: t_eig(gs, M_FREQS))
    try:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{http_port}/healthz", timeout=10) as r:
            assert json.loads(r.read()) == {"status": "ok", "requests": 0}
        out = _post(http_port, "/predict",
                    {"graphs": [_wire(g) for g in tg]})
        np.testing.assert_array_equal(np.asarray(out["logits"], np.float32),
                                      pred.predict(tg))
        for bad in ({"graphs": [{"bogus": 1}]},
                    {"graphs": [{"x_int": [1, 2], "edge_index": [[0], [5]],
                                 "edge_type": [1]}]}):
            with pytest.raises(urllib.error.HTTPError) as e:
                _post(http_port, "/predict", bad)
            assert e.value.code == 400
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(http_port, "/predict", None, raw=b"{not json")
        assert e.value.code == 400
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(http_port, "/other", {})
        assert e.value.code == 404
        again = _post(http_port, "/predict", {"graphs": [_wire(tg[0])]})
        assert np.asarray(again["logits"]).shape == (1, 1)
        with urllib.request.urlopen(
                f"http://127.0.0.1:{http_port}/healthz", timeout=10) as r:
            assert json.loads(r.read())["requests"] == 2
    finally:
        srv.shutdown()


def test_http_server_takes_64_connections_at_once():
    """64 clients connect at the same moment to a server whose handlers
    hold the GIL through each request (as a forward does): every one is
    answered. The stdlib's listen backlog of 5 reset most of them."""
    import time

    class Busy:
        def predict(self, graphs):
            t0 = time.time()
            while time.time() - t0 < 0.05:
                sum(range(1000))
            return np.zeros((len(graphs), 1), np.float32)

    srv, port = start_background(Busy(), port=0)
    body = json.dumps({"graphs": [{"x_int": [1, 2],
                                   "edge_index": [[0, 1], [1, 0]]}]}).encode()
    answers, errors = [], []
    barrier = threading.Barrier(64)

    def post():
        barrier.wait()
        try:
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}/predict", data=body,
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=60) as r:
                answers.append(json.loads(r.read())["logits"])
        except Exception as e:              # noqa: BLE001 - counted below
            errors.append(repr(e))

    threads = [threading.Thread(target=post) for _ in range(64)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        srv.shutdown()
        srv.server_close()
    assert errors == [] and answers == [[[0.0]]] * 64
