"""The config-driven TU graph classification trainer of the LPE/LSPE tier.

    python -m feta_tmlr_tpu_torch.experiments.main_TU_graph_classification \
        --config configs/LPE/ZINC/optimized.json --dataset MUTAG \
        --datadir dataset [--model SAN] [--device cpu]

One fold of a TU dataset (the on-disk fold-idx files when present, else
the stratified split) with float (one-hot) node features and no bond
types, cross-entropy and accuracy, the plateau schedule, the test fold as
the validation split. The JAX package's eight names: the SAN family
(SAN, SAN_NodeLPE, SAN_EdgeLPE, SAN_NodeSpectra: the Laplacian eigen-PE,
its eigenvector signs flipped in training) and the LSPE nets (GatedGCN,
PNA with the graphs' degree statistic, GraphiT, Spectra: the random-walk
PE of pos_enc_dim columns as the p channel). Falls back to synthetic
graphs when --datadir/--dataset is absent. Runs on the card unless
`--device cpu`; `--outdir`, `--ckpt-dir` and `--resume` as the other
config trainers.
"""

from __future__ import annotations

import argparse
import os

from feta_tmlr_tpu_torch.data.synthetic import random_graph_dataset
from feta_tmlr_tpu_torch.data.tu import load_fold_indices, load_tu_dataset
from feta_tmlr_tpu_torch.device import resolve_device
from feta_tmlr_tpu_torch.experiments.common import (
    add_device_flag,
    make_batches,
    run_and_log,
    set_accepted_defaults,
)
from feta_tmlr_tpu_torch.nn.gatedgcn import GatedGCNLSPENet
from feta_tmlr_tpu_torch.nn.lspe import GraphiTSpectraNet
from feta_tmlr_tpu_torch.nn.pna import PNALSPENet, average_log_degree
from feta_tmlr_tpu_torch.nn.san import SANNet, SANNodeSpectra
from feta_tmlr_tpu_torch.pe.laplace import apply_laplace_decomp
from feta_tmlr_tpu_torch.pe.rwpe import apply_rwpe
from feta_tmlr_tpu_torch.train.trainer import TrainConfig, Trainer
from feta_tmlr_tpu_torch.utils.config import (
    load_config,
    model_kwargs_for,
    resolve_reference_model_name,
)

# name -> (class, fixed kwargs): float features in
MODELS = {
    "SAN": (SANNet, {}),
    "SAN_NodeLPE": (SANNet, {"lpe": "node"}),
    "SAN_EdgeLPE": (SANNet, {"lpe": "edge"}),
    "SAN_NodeSpectra": (SANNodeSpectra, {}),
    "GatedGCN": (GatedGCNLSPENet, {"categorical_input": False}),
    "PNA": (PNALSPENet, {"categorical_input": False}),
    "GraphiT": (GraphiTSpectraNet, {"spectra": False,
                                    "categorical_input": False}),
    "Spectra": (GraphiTSpectraNet, {"categorical_input": False}),
}
SAN_MODELS = (SANNet, SANNodeSpectra)
LSPE_MODELS = (GatedGCNLSPENet, PNALSPENet, GraphiTSpectraNet)


def rw_dim(cfg) -> int:
    """The LSPE nets' p channel: pos_enc_dim random-walk PE columns."""
    return cfg["net_params"].get("pos_enc_dim", 12)


def resolve_build(cfg, model_arg=None):
    """(cls, kwargs) for a config (or --model): JAX's names and defaults,
    float features in, no bond types."""
    name = resolve_reference_model_name(cfg, model_arg)
    if name not in MODELS:
        raise SystemExit(f"unknown model {name}; "
                         f"choose from {sorted(MODELS)}")
    cls, extra = MODELS[name]
    kwargs = model_kwargs_for(cls, cfg["net_params"])
    kwargs.update(extra)
    set_accepted_defaults(cls, kwargs, hidden_dim=32, out_dim=32,
                          n_heads=4, n_layers=3, lpe_dim=8,
                          categorical_input=False,
                          # the TU graphs carry no bond types
                          edge_features=False)
    if cls in LSPE_MODELS:
        kwargs.setdefault("pos_enc_dim", rw_dim(cfg))
    return cls, kwargs


def pe_precompute(graphs, cls, cfg, max_freqs=10):
    """The eigen-PE of every graph (as JAX's trainer computes it for all
    nets) and, for the LSPE nets, the random-walk PE as `lap_pe`."""
    apply_laplace_decomp(graphs, max_freqs)
    if cls in LSPE_MODELS:
        apply_rwpe(graphs, rw_dim(cfg))


def construct_model(cls, kwargs, graphs, n_classes, seed=0, device=None):
    """The model over the graphs' float features (PNA with their degree
    statistic), weights from `seed`, on `device` (default CUDA)."""
    if cls is PNALSPENet:
        kwargs = dict({"avg_d_log": average_log_degree(graphs)}, **kwargs)
    return cls(num_atom_type=1, num_bond_type=1, n_out=n_classes,
               in_feat_dim=graphs[0].x.shape[-1], seed=seed, device=device,
               **kwargs)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--config", type=str, default=None)
    p.add_argument("--model", type=str, default=None)
    p.add_argument("--dataset", type=str, default="NCI1")
    p.add_argument("--datadir", type=str, default="dataset")
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--fold-idx", type=int, default=1)
    p.add_argument("--seed", type=int, default=41)
    p.add_argument("--max_freqs", type=int, default=10)
    p.add_argument("--synthetic-graphs", type=int, default=60)
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
    epochs = args.epochs or params.get("epochs", 100)

    path = os.path.join(args.datadir, args.dataset)
    if os.path.isdir(path):
        graphs, _ = load_tu_dataset(args.dataset, args.datadir)
    else:
        print(f"[warn] {path} not found - synthetic fallback")
        graphs = random_graph_dataset(seed=args.seed,
                                      n_graphs=args.synthetic_graphs,
                                      n_features=7)
    n_classes = len({int(g.y) for g in graphs})
    pe_precompute(graphs, cls, cfg, args.max_freqs)
    tr_idx, te_idx = load_fold_indices(
        graphs, args.fold_idx, name=args.dataset,
        fold_dir=f"{args.datadir}/fold-idx", seed=args.seed)
    model = construct_model(cls, kwargs, graphs, n_classes, seed=args.seed,
                            device=device)

    max_nodes = max(g.num_nodes for g in graphs)
    batch_size = params.get("batch_size", 32)
    train_b = make_batches([graphs[i] for i in tr_idx], batch_size,
                           max_nodes, shuffle_seed=args.seed)
    test_b = make_batches([graphs[i] for i in te_idx], batch_size,
                          max_nodes)
    trainer = Trainer(
        model,
        TrainConfig(task="graph_clf", lr=params.get("init_lr", 1e-3),
                    epochs=epochs, schedule="plateau",
                    # the eigenvector sign flip of the SAN tier
                    sign_flip=cls in SAN_MODELS, seed=args.seed),
        steps_per_epoch=len(train_b))
    args.epochs = epochs
    # the JAX config trainer's results.csv: best_val and the test metrics
    return run_and_log(trainer, train_b, test_b, test_b, args, args.outdir,
                       summary_keys=("best_val",))


if __name__ == "__main__":
    main()
