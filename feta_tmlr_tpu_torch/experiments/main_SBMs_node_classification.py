"""The config-driven SBM node classifier of the LPE tier (PATTERN,
CLUSTER).

    python -m feta_tmlr_tpu_torch.experiments.main_SBMs_node_classification \
        --config configs/LPE/CLUSTER/optimized.json --data-dir data \
        [--ckpt-dir runs/ckpt] [--resume] [--outdir runs/out] [--device cpu]

`--config <json>` plus overrides, as the JAX package's trainer: the SAN
family (SAN, SAN_NodeLPE, SAN_EdgeLPE, SAN_NodeSpectra; the Laplacian
eigen-PE, sign flips) and the LSPE tier's GraphiT nets (GraphiTSpectra,
Spectra, GraphiT; the random-walk PE of 12 columns unless the config says,
the adaptive edge kernel) with the per-node readout and two bond types,
masked cross-entropy with class-balanced accuracy (`node_clf`) and the
plateau schedule. The config's `dataset` names the pickles under
`--data-dir` (SBMs/<name>_{train,val,test}.pkl); without them, synthetic
SBMs. Runs on the card unless `--device cpu`.
"""

from __future__ import annotations

import argparse

from feta_tmlr_tpu_torch.data.sbm import load_sbm_or_synthetic
from feta_tmlr_tpu_torch.device import resolve_device
from feta_tmlr_tpu_torch.experiments.common import (
    add_device_flag,
    lspe_precompute,
    make_batches,
    run_and_log,
    set_accepted_defaults,
)
from feta_tmlr_tpu_torch.nn.lspe import GraphiTSpectraNet
from feta_tmlr_tpu_torch.nn.san import SANNet, SANNodeSpectra
from feta_tmlr_tpu_torch.pe.laplace import apply_laplace_decomp
from feta_tmlr_tpu_torch.train.trainer import TrainConfig, Trainer
from feta_tmlr_tpu_torch.utils.config import (
    load_config,
    model_kwargs_for,
    resolve_reference_model_name,
)

# name -> (class, fixed kwargs)
MODELS = {"SAN": (SANNet, {}),
          "SAN_NodeLPE": (SANNet, {"lpe": "node"}),
          "SAN_EdgeLPE": (SANNet, {"lpe": "edge"}),
          "SAN_NodeSpectra": (SANNodeSpectra, {}),
          "GraphiTSpectra": (GraphiTSpectraNet, {}),
          "Spectra": (GraphiTSpectraNet, {}),
          "GraphiT": (GraphiTSpectraNet, {"spectra": False})}


def resolve_build(cfg, model_arg=None):
    """(cls, kwargs) for a config, with the tier's defaults for what it
    leaves out."""
    name = resolve_reference_model_name(cfg, model_arg)
    entry = MODELS.get(name)
    if entry is None:
        raise SystemExit(f"unknown model {name}; choose from "
                         f"{sorted(MODELS)}")
    cls, extra = entry
    kwargs = model_kwargs_for(cls, cfg["net_params"])
    kwargs.update(extra)
    set_accepted_defaults(cls, kwargs, hidden_dim=32, out_dim=32,
                          n_heads=4, n_layers=3)
    if cls is GraphiTSpectraNet:
        kwargs.setdefault("pos_enc_dim", 12)
    else:
        set_accepted_defaults(cls, kwargs, lpe_dim=8)
    return cls, kwargs


def pe_precompute(graphs, cls, kwargs, cfg, max_freqs=10):
    """The GraphiT nets' random-walk PE and adaptive edge kernel, or the
    SAN nets' Laplacian eigen-PE of `max_freqs` frequencies."""
    if cls is GraphiTSpectraNet:
        lspe_precompute(graphs, kwargs, cfg["net_params"])
    else:
        apply_laplace_decomp(graphs, max_freqs)


def construct_model(cls, kwargs, n_tags, n_classes, device=None,
                    seed: int = 0):
    """The node-level model over `n_tags` node ids and two bond types
    (real edges carry type 1), `n_classes` logits a node."""
    return cls(num_atom_type=n_tags, num_bond_type=2, node_level=True,
               n_out=n_classes, seed=seed, device=device, **kwargs)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--config", type=str, default=None)
    p.add_argument("--model", type=str, default=None)
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--seed", type=int, default=41)
    p.add_argument("--n-nodes", type=int, default=64)
    p.add_argument("--n-classes", type=int, default=2)
    p.add_argument("--max_freqs", type=int, default=10)
    p.add_argument("--synthetic-graphs", type=int, default=48)
    p.add_argument("--dataset", type=str, default="SBM_PATTERN")
    p.add_argument("--data-dir", type=str, default="data",
                   help="root holding SBMs/<name>_{train,val,test}.pkl")
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

    name = cfg.get("dataset", args.dataset)
    if not str(name).startswith("SBM_"):
        name = f"SBM_{name}"
    tr, va, te, _real = load_sbm_or_synthetic(
        args.data_dir, name, seed=args.seed,
        n_synthetic=args.synthetic_graphs, n_nodes=args.n_nodes,
        n_classes=args.n_classes, max_graphs_per_split=args.max_graphs)
    graphs = tr + va + te
    n_tags = int(max(int(g.x.max()) for g in graphs)) + 1
    n_classes = int(max(int(g.y.max()) for g in graphs)) + 1
    pe_precompute(graphs, cls, kwargs, cfg, args.max_freqs)
    model = construct_model(cls, kwargs, n_tags, n_classes, device=device,
                            seed=args.seed)

    max_nodes = max(g.num_nodes for g in graphs)
    batch_size = params.get("batch_size", 16)
    train_b = make_batches(tr, batch_size, max_nodes, shuffle_seed=args.seed,
                           node_labels=True)
    val_b = make_batches(va, batch_size, max_nodes, node_labels=True)
    test_b = make_batches(te, batch_size, max_nodes, node_labels=True)
    trainer = Trainer(
        model,
        TrainConfig(task="node_clf", lr=params.get("init_lr", 1e-3),
                    epochs=args.epochs, schedule="plateau",
                    sign_flip=cls is not GraphiTSpectraNet,
                    seed=args.seed),
        steps_per_epoch=len(train_b))
    return run_and_log(trainer, train_b, val_b, test_b, args, args.outdir,
                       summary_keys=("best_val",))


if __name__ == "__main__":
    main()
