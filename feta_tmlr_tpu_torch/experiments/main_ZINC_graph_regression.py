"""The config-driven ZINC trainer of the LPE/LSPE tier.

    python -m feta_tmlr_tpu_torch.experiments.main_ZINC_graph_regression \
        --config configs/LPE/ZINC/optimized.json \
        --data-dir data --ckpt-dir runs/ckpt [--resume] [--device cpu]

`--config <json>` plus overrides, the JAX package's registry of names and
the reference's protocol: plateau learning-rate schedule that stops at
min_lr or after max_time hours, per-epoch checkpoints, eigenvector sign
flips for the SAN models. The LPE tier's nets are ported (SAN,
SAN_NodeLPE, SAN_EdgeLPE, SAN_NodeSpectra, GAT, GATFeTA); the LSPE names
exit naming their ROADMAP item. Runs on the card unless `--device cpu`.
"""

from __future__ import annotations

import argparse

from feta_tmlr_tpu_torch.data.zinc import (
    NUM_ATOM_TYPE,
    NUM_BOND_TYPE,
    load_zinc_or_synthetic,
)
from feta_tmlr_tpu_torch.device import resolve_device
from feta_tmlr_tpu_torch.experiments.common import (
    add_device_flag,
    make_batches,
    run_and_log,
)
from feta_tmlr_tpu_torch.nn.gat import GATFeTANet, GATNet
from feta_tmlr_tpu_torch.nn.san import SANNet, SANNodeSpectra
from feta_tmlr_tpu_torch.pe.laplace import apply_laplace_decomp
from feta_tmlr_tpu_torch.train.trainer import TrainConfig, Trainer
from feta_tmlr_tpu_torch.utils.config import (
    load_config,
    model_kwargs_for,
    resolve_reference_model_name,
)

# name -> (class, fixed kwargs), or the ROADMAP item of a family not
# ported yet
MODEL_REGISTRY = {
    "SAN": (SANNet, {"lpe": "none"}),
    "GAT": (GATNet, {}),
    "SAN_NodeLPE": (SANNet, {"lpe": "node"}),
    "SAN_EdgeLPE": (SANNet, {"lpe": "edge"}),
    "SAN_NodeSpectra": (SANNodeSpectra, {}),
    "GATFeTA": (GATFeTANet, {}),
    "GraphiTSpectra": "Queue 1 item 8",
    "GraphiT": "Queue 1 item 8",
    "GatedGCN": "Queue 1 item 8",
    "SAN_LSPE": "Queue 1 item 8",
    "PNA": "Queue 1 item 8",
}
# the nets that read the eigen-PE: their eigenvector signs flip in training
SAN_MODELS = (SANNet, SANNodeSpectra)


def resolve_model_name(cfg, model_arg=None):
    return resolve_reference_model_name(
        cfg, model_arg,
        lspe_aliases={"SAN": "SAN_LSPE", "Spectra": "GraphiTSpectra"})


def resolve_build(cfg, model_arg=None):
    """(cls, kwargs) for a config: the registry and kwargs half of model
    construction, shared by the trainer and the serving CLI."""
    name = resolve_model_name(cfg, model_arg)
    if name not in MODEL_REGISTRY:
        raise SystemExit(f"unknown model {name}; "
                         f"choose from {sorted(MODEL_REGISTRY)}")
    entry = MODEL_REGISTRY[name]
    if isinstance(entry, str):
        ported = sorted(k for k, v in MODEL_REGISTRY.items()
                        if not isinstance(v, str))
        raise SystemExit(f"model {name} is not ported to "
                         f"feta_tmlr_tpu_torch yet (ROADMAP {entry}); "
                         f"ported: {', '.join(ported)}")
    cls, extra = entry
    kwargs = model_kwargs_for(cls, cfg["net_params"])
    kwargs.update(extra)
    return cls, kwargs


def construct_model(cls, kwargs, device=None, seed: int = 0):
    """The model with ZINC's atom vocabulary (and bond vocabulary, but
    for the GAT nets, which read no bonds), weights drawn from `seed`, on
    `device` (default CUDA)."""
    if cls not in (GATFeTANet, GATNet):
        kwargs = dict(kwargs, num_bond_type=NUM_BOND_TYPE)
    return cls(num_atom_type=NUM_ATOM_TYPE, seed=seed, device=device,
               **kwargs)


def pe_precompute(graphs, cls, kwargs, cfg, max_freqs=10):
    """The positional encodings the model reads, computed on its input
    graphs: the same transforms for training and for served requests (the
    SAN nets' Laplacian eigen-PE; the GAT nets read none)."""
    if cls in SAN_MODELS:
        apply_laplace_decomp(graphs, max_freqs)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--config", type=str, default=None)
    p.add_argument("--model", type=str, default=None)
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--init_lr", type=float, default=None)
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--seed", type=int, default=41)
    p.add_argument("--max_freqs", type=int, default=10)
    p.add_argument("--synthetic-graphs", type=int, default=96)
    p.add_argument("--data-dir", type=str, default="data",
                   help="root holding molecules/{train,val,test}.pickle")
    p.add_argument("--zinc-full", action="store_true",
                   help="load every molecule (ZINC-full) instead of the "
                        "10k/1k/1k index subset")
    p.add_argument("--max-graphs", type=int, default=None,
                   help="head-slice each real split (smoke runs)")
    p.add_argument("--outdir", type=str, default=None,
                   help="write logs.csv / results.csv here")
    p.add_argument("--ckpt-dir", type=str, default=None,
                   help="per-epoch keep-latest checkpoints")
    p.add_argument("--resume", action="store_true",
                   help="continue from the latest checkpoint in --ckpt-dir")
    add_device_flag(p)
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    cfg = (load_config(args.config) if args.config
           else {"model": "SAN_NodeSpectra", "params": {}, "net_params": {}})
    cls, kwargs = resolve_build(cfg, args.model)

    params = cfg["params"]
    epochs = args.epochs or params.get("epochs", 100)
    lr = args.init_lr or params.get("init_lr", 1e-3)
    batch_size = args.batch_size or params.get("batch_size", 128)

    tr, va, te, _real = load_zinc_or_synthetic(
        args.data_dir, seed=args.seed, n_synthetic=args.synthetic_graphs,
        subset=not args.zinc_full, max_graphs_per_split=args.max_graphs)
    graphs = tr + va + te
    pe_precompute(graphs, cls, kwargs, cfg, max_freqs=args.max_freqs)
    model = construct_model(cls, kwargs, device=device, seed=args.seed)

    max_nodes = max(g.num_nodes for g in graphs)
    train_b = make_batches(tr, batch_size, max_nodes, shuffle_seed=args.seed)
    val_b = make_batches(va, batch_size, max_nodes)
    test_b = make_batches(te, batch_size, max_nodes)
    trainer = Trainer(
        model,
        TrainConfig(task="graph_reg", lr=lr,
                    weight_decay=params.get("weight_decay", 0.0),
                    epochs=epochs, schedule="plateau",
                    plateau_patience=params.get("lr_schedule_patience", 10),
                    plateau_factor=params.get("lr_reduce_factor", 0.5),
                    min_lr=params.get("min_lr", 1e-5),
                    stop_at_min_lr=True,
                    max_time_h=params.get("max_time"),
                    sign_flip=cls in SAN_MODELS,
                    seed=args.seed),
        steps_per_epoch=len(train_b))
    args.epochs = epochs
    # the JAX config trainer's results.csv: best_val and the test metrics
    return run_and_log(trainer, train_b, val_b, test_b, args, args.outdir,
                       summary_keys=("best_val",))


if __name__ == "__main__":
    main()
