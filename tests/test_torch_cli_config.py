"""The port's config-driven ZINC trainer and serving CLI end to end on the
CPU: the trainer against the JAX one (same result keys, same `logs.csv`
and `results.csv` columns, finite losses), then `serve_main` started in
the background from the trainer's checkpoint, answering HTTP requests
with the logits of an in-process `Predictor` restored from the same
checkpoint (within 1e-5; the same weights, inputs and code on both sides,
so in practice exactly).
"""

import csv
import json
import os
import threading
import urllib.request

import numpy as np

from feta_tmlr_tpu_torch.data.synthetic import zinc_categorical_dataset
from feta_tmlr_tpu_torch.experiments import main_ZINC_graph_regression as tmain
from feta_tmlr_tpu_torch.experiments import serve_main
from feta_tmlr_tpu_torch.serve import Predictor

CFG = {"model": "GraphTransformer", "params": {"epochs": 2, "batch_size": 8},
       "net_params": {"LPE": "nodespectra", "GT_hidden_dim": 16,
                      "GT_out_dim": 16, "GT_n_heads": 2, "GT_layers": 1,
                      "LPE_dim": 4, "LPE_n_heads": 2, "LPE_layers": 1,
                      "readout": "sum", "batch_norm": True, "dropout": 0.0}}


def _header(path):
    with open(path) as f:
        return next(csv.reader(f))


def _post_graphs(port, graphs):
    """POST /predict of raw ZINC graphs; the logits as float32."""
    payload = {"graphs": [{"x_int": g.x.reshape(-1).tolist(),
                           "edge_index": g.edge_index.tolist(),
                           "edge_type": g.edge_type.tolist()}
                          for g in graphs]}
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/predict",
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return np.asarray(json.loads(r.read())["logits"], np.float32)


def _config(tmp_path):
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps(CFG))
    return str(cfg), ["--config", str(cfg), "--synthetic-graphs", "20",
                      "--max_freqs", "6", "--data-dir", "no-such-dir"]


def test_config_trainer_matches_jax_cli(tmp_path):
    from feta_tmlr_tpu.experiments import main_ZINC_graph_regression as jmain
    _, common = _config(tmp_path)
    want = jmain.main(common + ["--epochs", "1", "--outdir",
                                str(tmp_path / "jax")])
    ckpt = str(tmp_path / "ckpt")
    got = tmain.main(common + ["--outdir", str(tmp_path / "port"),
                               "--ckpt-dir", ckpt, "--device", "cpu"])
    assert sorted(got) == sorted(want)
    for name in ("logs.csv", "results.csv"):
        assert _header(tmp_path / "port" / name) == \
            _header(tmp_path / "jax" / name), name
    assert [r["epoch"] for r in got["history"]] == [0, 1]
    assert all(np.isfinite(r["loss"]) for r in got["history"])
    assert "lr" in got["history"][0]
    resumed = tmain.main(common + ["--epochs", "3", "--ckpt-dir", ckpt,
                                   "--resume", "--device", "cpu"])
    assert [r["epoch"] for r in resumed["history"]] == [2]
    assert os.path.isfile(os.path.join(ckpt, "fit_meta.json"))


def test_serve_main_answers_from_the_trainer_checkpoint(tmp_path):
    cfg, common = _config(tmp_path)
    ckpt = str(tmp_path / "ckpt")
    tmain.main(common + ["--ckpt-dir", ckpt, "--device", "cpu"])
    srv, port, pred = serve_main.main(
        ["--config", cfg, "--ckpt-dir", ckpt, "--warmup", "--port", "0",
         "--max-batch", "4", "--max-nodes", "32", "--max_freqs", "6",
         "--device", "cpu"], background=True)
    try:
        graphs = zinc_categorical_dataset(seed=9, n_graphs=6)
        served = _post_graphs(port, graphs)
    finally:
        srv.shutdown()
    assert pred.compile_stats()["shapes"] == [(4, 32)]
    model, preprocess, _ = serve_main.build_from_config(
        cfg, max_freqs=6, device="cpu")
    preprocess(graphs)
    direct = Predictor(model, device="cpu", ckpt_dir=ckpt, max_batch=4,
                       collate_kwargs={"max_nodes": 32}).predict(graphs)
    assert served.shape == (6, 1)
    np.testing.assert_allclose(served, direct, rtol=1e-5, atol=1e-5)


def test_serve_main_gives_eight_concurrent_posts_their_own_logits(tmp_path):
    """Eight POSTs of different graphs at once, each of several chunks,
    served by handler threads that call the same Predictor: every answer
    is the direct Predictor's for its own graphs."""
    cfg, _ = _config(tmp_path)
    argv = ["--config", cfg, "--max-batch", "2", "--max-nodes", "32",
            "--max_freqs", "6", "--device", "cpu"]
    srv, port, _ = serve_main.main(argv + ["--port", "0"], background=True)
    graphs = zinc_categorical_dataset(seed=5, n_graphs=8 * 7)
    requests = [graphs[i * 7:(i + 1) * 7] for i in range(8)]
    served = [None] * 8
    barrier = threading.Barrier(8)

    def post(i):
        barrier.wait()
        served[i] = _post_graphs(port, requests[i])

    try:
        threads = [threading.Thread(target=post, args=(i,))
                   for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        srv.shutdown()
        srv.server_close()
    model, preprocess, _ = serve_main.build_from_config(
        cfg, max_freqs=6, device="cpu")
    direct = Predictor(model, device="cpu", max_batch=2,
                       collate_kwargs={"max_nodes": 32})
    for req, got in zip(requests, served):
        preprocess(req)
        want = direct.predict(req)
        assert got is not None and got.shape == want.shape == (7, 1)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
