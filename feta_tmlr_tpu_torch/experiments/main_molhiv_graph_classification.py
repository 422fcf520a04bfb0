"""The config-driven ogbg-molhiv classifier of the LPE tier.

    python -m feta_tmlr_tpu_torch.experiments.main_molhiv_graph_classification \
        --config configs/LPE/MOLHIV/optimized_spectral_full_1.json \
        --data-dir data [--ckpt-dir runs/ckpt] [--resume] [--outdir runs/out] \
        [--device cpu]

`--config <json>` plus overrides, as the JAX package's trainer: the SAN
family (SAN, SAN_NodeLPE, SAN_EdgeLPE, SAN_NodeSpectra) on OGB molecules
whose atom features are cut to their first column (one categorical id a
node, as the tier's nets embed) and bond types (the first bond feature +
1), sigmoid binary cross-entropy with ROC-AUC selection, the plateau
schedule and eigenvector sign flips. The raw-CSV layout of ogbg-molhiv
under `--data-dir` when present, else synthetic molecule-shaped graphs
(`molhiv_like`). Runs on the card unless `--device cpu`.
"""

from __future__ import annotations

import argparse

import numpy as np

from feta_tmlr_tpu_torch.data.ogb_raw import load_ogb_or_synthetic
from feta_tmlr_tpu_torch.data.synthetic import random_connected_graph
from feta_tmlr_tpu_torch.device import resolve_device
from feta_tmlr_tpu_torch.experiments.common import (
    add_device_flag,
    make_batches,
    run_and_log,
    set_accepted_defaults,
)
from feta_tmlr_tpu_torch.nn.san import SANNet, SANNodeSpectra
from feta_tmlr_tpu_torch.pe.laplace import apply_laplace_decomp
from feta_tmlr_tpu_torch.train.trainer import TrainConfig, Trainer
from feta_tmlr_tpu_torch.utils.config import (
    load_config,
    model_kwargs_for,
    resolve_reference_model_name,
)

MODELS = {"SAN": (SANNet, {}),
          "SAN_NodeLPE": (SANNet, {"lpe": "node"}),
          "SAN_EdgeLPE": (SANNet, {"lpe": "edge"}),
          "SAN_NodeSpectra": (SANNodeSpectra, {})}
NUM_ATOM_TYPE = 119
NUM_BOND_TYPE = 5


def molhiv_like(seed, n_graphs, num_atom_type=NUM_ATOM_TYPE,
                num_bond_type=NUM_BOND_TYPE):
    """Molecule-shaped graphs of 8-27 atoms with one atom id a node, bond
    types per edge and a binary label, one positive in five."""
    rng = np.random.default_rng(seed)
    graphs = []
    for i in range(n_graphs):
        n = int(rng.integers(8, 28))
        g = random_connected_graph(rng, n, 1, edge_prob=0.15)
        g.x = rng.integers(0, num_atom_type, (n, 1)).astype(np.int32)
        g.edge_type = rng.integers(0, num_bond_type,
                                   g.num_edges).astype(np.int32)
        g.y = np.float32(i % 5 == 2)
        graphs.append(g)
    return graphs


def resolve_build(cfg, model_arg=None):
    """(cls, kwargs) for a config, with the tier's defaults for what it
    leaves out."""
    name = resolve_reference_model_name(cfg, model_arg)
    if name not in MODELS:
        raise SystemExit(f"unknown model {name}; choose from "
                         f"{sorted(MODELS)}")
    cls, extra = MODELS[name]
    kwargs = model_kwargs_for(cls, cfg["net_params"])
    kwargs.update(extra)
    set_accepted_defaults(cls, kwargs, hidden_dim=32, out_dim=32,
                          n_heads=4, n_layers=3, lpe_dim=8)
    return cls, kwargs


def construct_model(cls, kwargs, device=None, seed: int = 0):
    """The one-logit model over ogbg-molhiv's atom and bond vocabularies."""
    return cls(num_atom_type=NUM_ATOM_TYPE, num_bond_type=NUM_BOND_TYPE,
               n_out=1, seed=seed, device=device, **kwargs)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--config", type=str, default=None)
    p.add_argument("--model", type=str, default=None)
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--seed", type=int, default=41)
    p.add_argument("--max_freqs", type=int, default=10)
    p.add_argument("--synthetic-graphs", type=int, default=64)
    p.add_argument("--data-dir", type=str, default="data",
                   help="root holding ogbg_molhiv/raw CSVs")
    p.add_argument("--max-graphs", type=int, default=None)
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
           else {"model": args.model, "params": {}, "net_params": {}})
    cls, kwargs = resolve_build(cfg, args.model)
    params = cfg["params"]
    args.epochs = args.epochs or params.get("epochs", 50)

    tr, va, te, used_real = load_ogb_or_synthetic(
        args.data_dir, "ogbg-molhiv",
        lambda: molhiv_like(args.seed, args.synthetic_graphs),
        min_nodes=6, max_graphs=args.max_graphs)
    graphs = tr + va + te
    if used_real:
        for g in graphs:
            g.x = g.x[:, :1].astype(np.int32)
    apply_laplace_decomp(graphs, args.max_freqs)
    model = construct_model(cls, kwargs, device=device, seed=args.seed)

    max_nodes = max(g.num_nodes for g in graphs)
    batch_size = params.get("batch_size", 32)
    train_b = make_batches(tr, batch_size, max_nodes, shuffle_seed=args.seed)
    val_b = make_batches(va, batch_size, max_nodes)
    test_b = make_batches(te, batch_size, max_nodes) if te else None
    trainer = Trainer(
        model,
        TrainConfig(task="binary_graph", lr=params.get("init_lr", 1e-3),
                    epochs=args.epochs, schedule="plateau", sign_flip=True,
                    binary_metric="rocauc", seed=args.seed),
        steps_per_epoch=len(train_b))
    return run_and_log(trainer, train_b, val_b, test_b, args, args.outdir,
                       summary_keys=("best_val",))


if __name__ == "__main__":
    main()
