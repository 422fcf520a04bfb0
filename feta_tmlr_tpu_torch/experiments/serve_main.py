"""Serving CLI: a config-driven model over HTTP.

    python -m feta_tmlr_tpu_torch.experiments.serve_main \
        --config configs/LPE/ZINC/optimized.json \
        --ckpt-dir runs/ckpt --warmup [--port 8000] [--device cpu]

    POST /predict {"graphs": [{"x_int": [...], "edge_index": [[..],[..]],
                               "edge_type": [...]}]} -> {"logits": [...]}

The model is built as the config-driven ZINC trainer builds it (same JSON
schema, same registry: the graph-level nets of the LPE tier, the SAN nets
with their eigen-PE, GAT and GATFeTA, and the LSPE nets), its weights
restored from the trainer's latest checkpoint (random weights from a seed
without `--ckpt-dir`), and the positional encodings (eigen-PE, random-walk
PE, the adaptive edge kernel) are computed server-side with the training
transforms, so clients send only ids, edges and bond types. PNA needs the
training set's degree statistic in the config (net_params.avg_d_log) and
refuses without it. `--warmup`
runs the serving shape once before listening, which builds the CUDA
kernels. Runs on the card unless `--device cpu`. `--wire` and
`--quantize` (JAX serving options) are not ported and refuse.
"""

from __future__ import annotations

import argparse

from feta_tmlr_tpu_torch.data.synthetic import zinc_categorical_dataset
from feta_tmlr_tpu_torch.device import resolve_device
from feta_tmlr_tpu_torch.experiments.common import (
    add_device_flag,
    refuse,
)
from feta_tmlr_tpu_torch.experiments.main_ZINC_graph_regression import (
    construct_model,
    pe_precompute,
    resolve_build,
)
from feta_tmlr_tpu_torch.nn.pna import PNALSPENet
from feta_tmlr_tpu_torch.serve import Predictor
from feta_tmlr_tpu_torch.serve_http import serve_forever, start_background
from feta_tmlr_tpu_torch.utils.config import load_config


def build_from_config(config_path=None, model_arg=None, max_freqs=10,
                      device=None):
    """(model, preprocess_fn, sample_graphs) for serving: the trainer's
    resolve / construct path."""
    cfg = (load_config(config_path) if config_path
           else {"model": "SAN_NodeSpectra", "params": {},
                 "net_params": {}})
    cls, kwargs = resolve_build(cfg, model_arg)

    def preprocess(graphs):
        pe_precompute(graphs, cls, kwargs, cfg, max_freqs=max_freqs)

    sample = zinc_categorical_dataset(seed=0, n_graphs=4)
    preprocess(sample)
    if cls is PNALSPENet and "avg_d_log" not in kwargs:
        # a training-set statistic baked into PNA's degree scalers: without
        # it the served function is not the trained one
        raise SystemExit(
            "PNA serving needs net_params.avg_d_log in the config "
            "(the training dataset's average log degree)")
    return construct_model(cls, kwargs, device=device), preprocess, sample


def main(argv=None, background: bool = False):
    """Serve until interrupted; with `background`, start the server on a
    daemon thread and return (server, port, predictor)."""
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--config", type=str, default=None)
    p.add_argument("--model", type=str, default=None)
    p.add_argument("--ckpt-dir", type=str, default=None,
                   help="checkpoint dir of a training run (--ckpt-dir of "
                        "the mains); omitted -> random weights from a seed")
    p.add_argument("--host", type=str, default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--max-batch", type=int, default=64)
    p.add_argument("--max-nodes", type=int, default=64)
    p.add_argument("--max_freqs", type=int, default=10)
    p.add_argument("--wire", action="store_true",
                   help="compact wire format for device upload (not ported)")
    p.add_argument("--quantize", action="store_true",
                   help="weight-only int8 parameters (not ported)")
    p.add_argument("--warmup", action="store_true",
                   help="run the serving shape once before listening")
    add_device_flag(p)
    args = p.parse_args(argv)
    if args.wire:
        refuse("--wire (data/wire.py)", "Queue 1 item 9")
    if args.quantize:
        refuse("--quantize (quantize.py)", "Queue 1 item 11")
    device = resolve_device(args.device)

    model, preprocess, sample = build_from_config(
        args.config, args.model, args.max_freqs, device=device)
    pred = Predictor(model, device=device, ckpt_dir=args.ckpt_dir,
                     max_batch=args.max_batch,
                     collate_kwargs={"max_nodes": args.max_nodes})
    if args.warmup:
        n = pred.warmup(sample[0])
        print(f"warmed up {n} serving shape(s)")
    if background:
        srv, port = start_background(pred, args.host, args.port,
                                     preprocess=preprocess)
        print(f"serving on http://{args.host}:{port}")
        return srv, port, pred
    serve_forever(pred, args.host, args.port, preprocess=preprocess)


if __name__ == "__main__":
    main()
