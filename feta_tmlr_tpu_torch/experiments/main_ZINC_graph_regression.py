"""The config-driven ZINC trainer of the LPE/LSPE tier.

    python -m feta_tmlr_tpu_torch.experiments.main_ZINC_graph_regression \
        --config configs/LPE/ZINC/optimized.json \
        --data-dir data --ckpt-dir runs/ckpt [--resume] [--device cpu]

`--config <json>` plus overrides, the JAX package's registry of names and
the reference's protocol: plateau learning-rate schedule that stops at
min_lr or after max_time hours, per-epoch checkpoints, eigenvector sign
flips for the SAN models. The LPE tier's nets (SAN, SAN_NodeLPE,
SAN_EdgeLPE, SAN_NodeSpectra, GAT, GATFeTA) and the LSPE tier's
(GraphiTSpectra, GraphiT, GatedGCN, SAN_LSPE, PNA: the random-walk PE, the
adaptive edge kernel, the lapeig loss term, PNA's degree statistic). Runs
on the card unless `--device cpu`.
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
    lspe_precompute,
    make_batches,
    pna_kwargs,
    run_and_log,
)
from feta_tmlr_tpu_torch.nn.gat import GATFeTANet, GATNet
from feta_tmlr_tpu_torch.nn.gatedgcn import GatedGCNLSPENet
from feta_tmlr_tpu_torch.nn.lspe import GraphiTSpectraNet
from feta_tmlr_tpu_torch.nn.pna import PNALSPENet, average_log_degree
from feta_tmlr_tpu_torch.nn.san import SANNet, SANNodeSpectra
from feta_tmlr_tpu_torch.nn.san_lspe import SANLSPENet
from feta_tmlr_tpu_torch.pe.laplace import apply_laplace_decomp
from feta_tmlr_tpu_torch.train.trainer import TrainConfig, Trainer
from feta_tmlr_tpu_torch.utils.config import (
    load_config,
    model_kwargs_for,
    resolve_reference_model_name,
)

# name -> (class, fixed kwargs)
MODEL_REGISTRY = {
    "SAN": (SANNet, {"lpe": "none"}),
    "GAT": (GATNet, {}),
    "SAN_NodeLPE": (SANNet, {"lpe": "node"}),
    "SAN_EdgeLPE": (SANNet, {"lpe": "edge"}),
    "SAN_NodeSpectra": (SANNodeSpectra, {}),
    "GATFeTA": (GATFeTANet, {}),
    "GraphiTSpectra": (GraphiTSpectraNet, {}),
    "GraphiT": (GraphiTSpectraNet, {"spectra": False}),
    "GatedGCN": (GatedGCNLSPENet, {}),
    "SAN_LSPE": (SANLSPENet, {}),
    "PNA": (PNALSPENet, {}),
}
# the nets that read the eigen-PE: their eigenvector signs flip in training
SAN_MODELS = (SANNet, SANNodeSpectra)
# the nets that read the random-walk (or Laplacian) PE as their p channel
LSPE_MODELS = (GraphiTSpectraNet, GatedGCNLSPENet, SANLSPENet, PNALSPENet)


def resolve_model_name(cfg, model_arg=None):
    return resolve_reference_model_name(
        cfg, model_arg,
        lspe_aliases={"SAN": "SAN_LSPE", "Spectra": "GraphiTSpectra"})


def resolve_build(cfg, model_arg=None):
    """(cls, kwargs) for a config: the registry and kwargs half of model
    construction, shared by the trainer and the serving CLI. PNA also
    takes the config's `PNA_NET_PARAMS` (`experiments/common.py`)."""
    name = resolve_model_name(cfg, model_arg)
    if name not in MODEL_REGISTRY:
        raise SystemExit(f"unknown model {name}; "
                         f"choose from {sorted(MODEL_REGISTRY)}")
    cls, extra = MODEL_REGISTRY[name]
    kwargs = model_kwargs_for(cls, cfg["net_params"])
    kwargs.update(extra)
    if cls is PNALSPENet:
        kwargs.update(pna_kwargs(cfg["net_params"]))
    return cls, kwargs


def construct_model(cls, kwargs, device=None, seed: int = 0,
                    avg_d_log=None):
    """The model with ZINC's atom vocabulary (and bond vocabulary, but
    for the GAT nets, which read no bonds), weights drawn from `seed`, on
    `device` (default CUDA). PNA takes `avg_d_log`, the training graphs'
    degree statistic, unless its kwargs carry one (a served model must
    get the value it was trained with: net_params.avg_d_log)."""
    if cls is PNALSPENet and avg_d_log is not None:
        kwargs = dict({"avg_d_log": avg_d_log}, **kwargs)
    if cls not in (GATFeTANet, GATNet):
        kwargs = dict(kwargs, num_bond_type=NUM_BOND_TYPE)
    return cls(num_atom_type=NUM_ATOM_TYPE, seed=seed, device=device,
               **kwargs)


def pe_precompute(graphs, cls, kwargs, cfg, max_freqs=10):
    """The positional encodings the model reads, computed on its input
    graphs: the same transforms for training and for served requests (the
    SAN nets' Laplacian eigen-PE; the LSPE nets' random-walk or Laplacian
    PE and the adaptive edge kernel, `common.lspe_precompute`; the GAT
    nets read none)."""
    if cls in SAN_MODELS:
        apply_laplace_decomp(graphs, max_freqs)
    if cls in LSPE_MODELS:
        lspe_precompute(graphs, kwargs, cfg["net_params"])


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
    model = construct_model(cls, kwargs, device=device, seed=args.seed,
                            avg_d_log=(average_log_degree(graphs)
                                       if cls is PNALSPENet else None))

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
                    # the lapeig nets return the pre-weighted loss term
                    regularization=(1.0 if kwargs.get("use_lapeig_loss")
                                    else 0.0),
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
