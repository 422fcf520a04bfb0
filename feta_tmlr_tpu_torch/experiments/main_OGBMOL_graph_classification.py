"""The config-driven OGB molecule multitask classifier of the LSPE tier
(MOLTOX21, MOLPCBA).

    python -m \
        feta_tmlr_tpu_torch.experiments.main_OGBMOL_graph_classification \
        --config configs/LSPE/GatedGCN_MOLPCBA_LSPE.json --data-dir data \
        [--ckpt-dir runs/ckpt] [--resume] [--outdir runs/out] [--device cpu]

`--config <json>` plus overrides, as the JAX package's trainer: GatedGCN,
PNA, GraphiT (with or without the spectral filter) and SAN, each with the
LSPE p channel, on OGB molecules whose atom features are cut to their
first column (one categorical id a node) with bond types, NaN-masked
multitask sigmoid cross-entropy (`binary_graph`), ROC-AUC selection on
MOLTOX21 and average precision on MOLPCBA, the plateau schedule and no
sign flips. The raw-CSV layout of ogbg-moltox21 / ogbg-molpcba under
`--data-dir` when present (its label table sets the task count), else
synthetic molecule-shaped graphs (`ogbmol_like`). The positional inputs
are the random-walk or Laplacian PE (no adaptive edge kernel, as in the
JAX trainer). PNA takes its towers, aggregators, scalers and bond
features from the config, and one tower where the config names none.
Runs on the card unless `--device cpu`.
"""

from __future__ import annotations

import argparse

import numpy as np

from feta_tmlr_tpu_torch.data.ogb_raw import load_ogb_or_synthetic
from feta_tmlr_tpu_torch.data.synthetic import random_connected_graph
from feta_tmlr_tpu_torch.device import resolve_device
from feta_tmlr_tpu_torch.experiments.common import (
    add_device_flag,
    lspe_precompute,
    make_batches,
    pna_kwargs,
    run_and_log,
)
from feta_tmlr_tpu_torch.nn.gatedgcn import GatedGCNLSPENet
from feta_tmlr_tpu_torch.nn.lspe import GraphiTSpectraNet
from feta_tmlr_tpu_torch.nn.pna import PNALSPENet, average_log_degree
from feta_tmlr_tpu_torch.nn.san_lspe import SANLSPENet
from feta_tmlr_tpu_torch.train.trainer import TrainConfig, Trainer
from feta_tmlr_tpu_torch.utils.config import load_config, model_kwargs_for

MODELS = {
    "GatedGCN": (GatedGCNLSPENet, {}),
    "PNA": (PNALSPENet, {}),
    "GraphiTSpectra": (GraphiTSpectraNet, {}),
    "Spectra": (GraphiTSpectraNet, {}),
    "GraphiT": (GraphiTSpectraNet, {"spectra": False}),
    "SAN": (SANLSPENet, {}),
}
N_TASKS = {"MOLTOX21": 12, "MOLPCBA": 128}
NUM_ATOM_TYPE = 119
NUM_BOND_TYPE = 5


def ogbmol_like(seed, n_graphs, n_tasks, num_atom_type=NUM_ATOM_TYPE,
                num_bond_type=NUM_BOND_TYPE):
    """Molecule-shaped graphs of 8-25 atoms with one atom id a node, bond
    types per edge and `n_tasks` binary labels, a quarter of them NaN
    (unlabelled)."""
    rng = np.random.default_rng(seed)
    graphs = []
    for _ in range(n_graphs):
        n = int(rng.integers(8, 26))
        g = random_connected_graph(rng, n, 1, edge_prob=0.15)
        g.x = rng.integers(0, num_atom_type, (n, 1)).astype(np.int32)
        g.edge_type = rng.integers(0, num_bond_type,
                                   g.num_edges).astype(np.int32)
        y = rng.integers(0, 2, n_tasks).astype(np.float32)
        y[rng.random(n_tasks) < 0.25] = np.nan
        g.y = y
        graphs.append(g)
    return graphs


def resolve_build(cfg, model_arg=None):
    """(cls, kwargs) for a config, with the trainer's defaults for what it
    leaves out (hidden and out width 32, 3 layers, pos_enc_dim 12; PNA one
    tower)."""
    name = model_arg or cfg.get("model") or "GatedGCN"
    if name not in MODELS:
        raise SystemExit(f"unknown model {name}; choose from "
                         f"{sorted(MODELS)}")
    cls, extra = MODELS[name]
    kwargs = model_kwargs_for(cls, cfg["net_params"])
    kwargs.update(extra)
    if cls is PNALSPENet:
        kwargs.update(pna_kwargs(cfg["net_params"]))
        kwargs.setdefault("towers", 1)
    kwargs.setdefault("hidden_dim", 32)
    kwargs.setdefault("out_dim", 32)
    kwargs.setdefault("n_layers", 3)
    kwargs.setdefault("pos_enc_dim", 12)
    return cls, kwargs


def dataset_of(cfg, dataset_arg=None) -> str:
    """MOLTOX21 or MOLPCBA from --dataset or the config's OGBG-* name."""
    dataset = (dataset_arg or str(cfg.get("dataset") or "MOLTOX21")
               .upper().replace("OGBG-", ""))
    if dataset not in N_TASKS:
        raise SystemExit(f"unknown dataset {dataset}; "
                         f"choose from {sorted(N_TASKS)}")
    return dataset


def construct_model(cls, kwargs, n_tasks, device=None, seed: int = 0):
    """The n_tasks-logit model over the OGB atom and bond vocabularies."""
    return cls(num_atom_type=NUM_ATOM_TYPE, num_bond_type=NUM_BOND_TYPE,
               n_out=n_tasks, seed=seed, device=device, **kwargs)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--config", type=str, default=None)
    p.add_argument("--model", type=str, default=None)
    p.add_argument("--dataset", type=str, default=None,
                   choices=sorted(N_TASKS))
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--seed", type=int, default=41)
    p.add_argument("--synthetic-graphs", type=int, default=64)
    p.add_argument("--data-dir", type=str, default="data",
                   help="root holding ogbg_<dataset>/raw CSVs")
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
    dataset = dataset_of(cfg, args.dataset)
    n_tasks = N_TASKS[dataset]

    tr, va, te, used_real = load_ogb_or_synthetic(
        args.data_dir, f"ogbg-{dataset.lower()}",
        lambda: ogbmol_like(args.seed, args.synthetic_graphs, n_tasks),
        min_nodes=6, max_graphs=args.max_graphs)
    graphs = tr + va + te
    if used_real:
        for g in graphs:
            g.x = g.x[:, :1].astype(np.int32)
        n_tasks = int(np.atleast_1d(graphs[0].y).shape[0])
    lspe_precompute(graphs, kwargs, cfg["net_params"], with_kernel=False)
    if cls is PNALSPENet:
        kwargs.setdefault("avg_d_log", average_log_degree(graphs))
    model = construct_model(cls, kwargs, n_tasks, device=device,
                            seed=args.seed)

    max_nodes = max(g.num_nodes for g in graphs)
    batch_size = params.get("batch_size", 32)
    train_b = make_batches(tr, batch_size, max_nodes, shuffle_seed=args.seed)
    val_b = make_batches(va, batch_size, max_nodes)
    test_b = make_batches(te, batch_size, max_nodes) if te else None
    trainer = Trainer(
        model,
        TrainConfig(task="binary_graph", lr=params.get("init_lr", 1e-3),
                    epochs=args.epochs, schedule="plateau", sign_flip=False,
                    regularization=(1.0 if kwargs.get("use_lapeig_loss")
                                    else 0.0),
                    binary_metric=("rocauc" if dataset == "MOLTOX21"
                                   else "ap"),
                    seed=args.seed),
        steps_per_epoch=len(train_b))
    return run_and_log(trainer, train_b, val_b, test_b, args, args.outdir,
                       summary_keys=("best_val",))


if __name__ == "__main__":
    main()
