"""Shared pieces of the command-line entry points.

The JAX package's `experiments/common.py` with the same flag names, nested
outdir naming, per-epoch `logs.csv` and final `results.csv`. Datasets are
read from --datadir when present; otherwise a synthetic fallback of the
same shapes is used and the run says so.

The port adds flags the JAX parser lacks: `--device` (default `cuda`; the
port never falls back to the CPU quietly, so `--device cuda` without a
card raises), `--ckpt-dir` (per-epoch checkpoints, `train/checkpoint.py`)
and `--resume` (continue from the latest of them). `--wire` and
`--quantize`, JAX serving options, are not ported and refuse.
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional, Sequence

import numpy as np

from feta_tmlr_tpu_torch.data.batch import (
    Graph,
    GraphBatch,
    collate_graphs,
    pad_bucket,
)
from feta_tmlr_tpu_torch.data.ogb_raw import load_ogb_or_synthetic
from feta_tmlr_tpu_torch.data.sbm import load_sbm_or_synthetic
from feta_tmlr_tpu_torch.data.synthetic import random_graph_dataset
from feta_tmlr_tpu_torch.data.tu import load_tu_dataset
from feta_tmlr_tpu_torch.data.zinc import NUM_ATOM_TYPE, load_zinc_or_synthetic
from feta_tmlr_tpu_torch.pe import POSENCODINGS, LapEncoding, PStepRWEncoding
from feta_tmlr_tpu_torch.pe.cache import PECache
from feta_tmlr_tpu_torch.pe.rwpe import apply_rwpe
from feta_tmlr_tpu_torch.train.logging import CSVLogger
from feta_tmlr_tpu_torch.utils.config import accepted_kwargs


def add_device_flag(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; raises without a card) or cpu")


def refuse(what: str, item: str) -> None:
    """Exit on an option of the JAX entry point that the port lacks."""
    raise SystemExit(f"{what} is not ported to feta_tmlr_tpu_torch yet "
                     f"(ROADMAP {item})")


def base_parser(dataset_default: str) -> argparse.ArgumentParser:
    """Flags shared by the run_transformer* family (reference names)."""
    p = argparse.ArgumentParser()
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--dataset", type=str, default=dataset_default)
    p.add_argument("--datadir", type=str, default="dataset")
    p.add_argument("--nb-heads", type=int, default=4)
    p.add_argument("--nb-layers", type=int, default=3)
    p.add_argument("--dim-hidden", type=int, default=64)
    p.add_argument("--pos-enc", choices=[None, "diffusion", "pstep", "adj"],
                   default=None)
    p.add_argument("--lappe", action="store_true")
    p.add_argument("--lap-dim", type=int, default=2)
    p.add_argument("--p", type=int, default=1)
    p.add_argument("--beta", type=float, default=1.0)
    p.add_argument("--normalization", choices=[None, "sym", "rw"],
                   default="sym")
    p.add_argument("--dropout", type=float, default=0.0)
    p.add_argument("--epochs", type=int, default=300)
    p.add_argument("--lr", type=float, default=0.001)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--outdir", type=str, default="")
    p.add_argument("--warmup", type=int, default=None)
    p.add_argument("--batch-norm", action="store_true")
    p.add_argument("--layer-norm", action="store_true",
                   help="use layer norm (ZINC-style scripts default to BN)")
    p.add_argument("--zero-diag", action="store_true")
    p.add_argument("--fold-idx", type=int, default=1)
    p.add_argument("--weight-decay", type=float, default=1e-4)
    p.add_argument("--test", action="store_true")
    p.add_argument("--gnn_type", type=str, default="ChebConvDynamic")
    p.add_argument("--filter_order", type=int, default=4)
    p.add_argument("--last_layer_filter", action="store_false")
    p.add_argument("--regularization", type=float, default=0.0)
    p.add_argument("--synthetic-graphs", type=int, default=120,
                   help="fallback dataset size when real data is absent")
    p.add_argument("--max-graphs", type=int, default=None,
                   help="head-slice each real split (smoke runs)")
    add_device_flag(p)
    p.add_argument("--ckpt-dir", type=str, default=None,
                   help="per-epoch keep-latest checkpoints")
    p.add_argument("--resume", action="store_true",
                   help="continue from the latest checkpoint in --ckpt-dir")
    return p


def check_ported_feta(args) -> None:
    """The FeTA CLIs' options the port's models do not take."""
    if args.gnn_type != "ChebConvDynamic":
        refuse(f"--gnn_type {args.gnn_type}", "Queue 1 item 5")
    if not args.last_layer_filter:
        refuse("--last_layer_filter (the filter in every layer)",
               "Queue 1 item 5")


def resolve_outdir(args, family: str = "transformer") -> Optional[str]:
    """Nested outdir naming of the reference trainers."""
    if not args.outdir:
        return None
    lapdir = "NoPE" if not args.lappe else f"Lap{args.lap_dim}"
    bn = "BN" if args.batch_norm else "LN"
    parts = [args.outdir, family, args.dataset]
    if args.zero_diag:
        parts.append("zero_diag")
    parts.append(lapdir)
    parts.append("_".join(str(v) for v in (
        args.weight_decay, args.dropout, args.lr, args.nb_layers,
        args.nb_heads, args.dim_hidden, bn, args.pos_enc,
        args.normalization, args.p, args.beta)))
    if hasattr(args, "fold_idx"):
        parts.append(f"fold-{args.fold_idx}")
    out = os.path.join(*parts)
    os.makedirs(out, exist_ok=True)
    return out


def set_accepted_defaults(model_cls, kwargs: dict, **defaults) -> dict:
    """setdefault() only for the constructor arguments `model_cls` names
    (the config-driven mains share one default block across model
    families whose signatures differ)."""
    accepted = accepted_kwargs(model_cls)
    for k, v in defaults.items():
        if k in accepted:
            kwargs.setdefault(k, v)
    return kwargs


# the reference PNA net's net_params that the shared name map does not
# carry (the JAX package's trainers drop them and build PNA with its
# defaults, 4 towers and no bond features, which do not divide the
# configs' hidden widths 55, 70, 206, 322 and 510)
PNA_NET_PARAMS = ("towers", "aggregators", "scalers", "edge_feat",
                  "edge_dim", "gru", "graph_norm", "pretrans_layers",
                  "posttrans_layers", "avg_d_log")


def pna_kwargs(net_params: dict) -> dict:
    """The PNA_NET_PARAMS a config gives, as PNALSPENet's arguments."""
    return {k: net_params[k] for k in PNA_NET_PARAMS if k in net_params}


def lspe_precompute(graphs: Sequence[Graph], kwargs: dict, net_params: dict,
                    default_dim: int = 20, with_kernel: bool = True):
    """The LSPE nets' positional inputs: the random-walk PE
    (`pe_init="rand_walk"`) or the Laplacian eigenvectors (`"lap_pe"`) of
    pos_enc_dim columns as `lap_pe`, nothing for `"no_pe"`; and, with
    `adaptive_edge_pe` and `with_kernel`, the p-step kernel (I - gamma
    L_sym)^p_steps as `pe` (net_params' p_steps and gamma, default 2 and
    0.25)."""
    dim = kwargs.get("pos_enc_dim", default_dim)
    pe_init = kwargs.get("pe_init", "rand_walk")
    if pe_init == "rand_walk":
        apply_rwpe(graphs, dim)
    elif pe_init == "lap_pe":
        LapEncoding(dim, normalization="sym").apply_to(graphs)
    if with_kernel and kwargs.get("adaptive_edge_pe"):
        PStepRWEncoding(p=net_params.get("p_steps", 2),
                        beta=net_params.get("gamma", 0.25),
                        normalization="sym").apply_to(graphs)
    return graphs


def load_tu_or_synthetic(args):
    """(graphs, in_size, n_classes, used_real): the TU dataset under
    --datadir/--dataset, else a synthetic set of learnable graphs."""
    path = os.path.join(args.datadir, args.dataset)
    if os.path.isdir(path):
        graphs, _ = load_tu_dataset(args.dataset, args.datadir)
        n_classes = len({int(g.y) for g in graphs})
        return graphs, graphs[0].x.shape[-1], n_classes, True
    print(f"[warn] dataset dir {path} not found - using synthetic fallback "
          f"({args.synthetic_graphs} graphs)")
    graphs = random_graph_dataset(
        seed=args.seed, n_graphs=args.synthetic_graphs, min_nodes=8,
        max_nodes=24, n_features=7, n_classes=2)
    return graphs, 7, 2, False


def onehot_x(graphs: Sequence[Graph], n_tags: int) -> Sequence[Graph]:
    """Categorical node ids -> one-hot float features (modulo n_tags), the
    transformer tier's input convention."""
    eye = np.eye(n_tags, dtype=np.float32)
    for g in graphs:
        if np.issubdtype(g.x.dtype, np.integer):
            g.x = eye[g.x.reshape(-1).astype(np.int64) % n_tags]
    return graphs


def load_zinc_tier(args, onehot: bool = True):
    """(train, val, test, in_size, used_real): the ZINC pickles under
    --datadir (molecules/ layout) when present, else the synthetic
    fallback; with onehot, atom ids become [n, 28] one-hot floats."""
    tr, va, te, used = load_zinc_or_synthetic(
        args.datadir, seed=args.seed, n_synthetic=args.synthetic_graphs,
        max_graphs_per_split=getattr(args, "max_graphs", None))
    if onehot:
        for split in (tr, va, te):
            onehot_x(split, NUM_ATOM_TYPE)
    return tr, va, te, NUM_ATOM_TYPE, used


def load_sbm_tier(args, onehot: bool = True):
    """(train, val, test, in_size, n_classes, used_real) for the SBM
    runners: --dataset 'PATTERN' or 'SBM_PATTERN' (or CLUSTER); the
    pickles under --datadir (SBMs/ layout) when present."""
    name = str(args.dataset)
    if not name.startswith("SBM_"):
        name = f"SBM_{name}"
    tr, va, te, used = load_sbm_or_synthetic(
        args.datadir, name, seed=args.seed,
        n_synthetic=args.synthetic_graphs,
        n_nodes=getattr(args, "n_nodes", 96),
        max_graphs_per_split=getattr(args, "max_graphs", None))
    all_graphs = tr + va + te
    n_tags = int(max(int(g.x.max()) for g in all_graphs)) + 1
    n_classes = int(max(int(g.y.max()) for g in all_graphs)) + 1
    if onehot:
        for split in (tr, va, te):
            onehot_x(split, n_tags)
    return tr, va, te, n_tags, n_classes, used


def load_ogb_tier(args, name: str, synthetic_fn,
                  min_nodes: Optional[int] = None):
    """(train, val, test, used_real) for the OGB runners; the raw-CSV
    layout under --datadir when present."""
    return load_ogb_or_synthetic(
        args.datadir, name, synthetic_fn, min_nodes=min_nodes,
        max_graphs=getattr(args, "max_graphs", None))


def apply_position_encodings(graphs: Sequence[Graph], args,
                             cache_dir: Optional[str] = None):
    """The reference trainers' PE wiring: --pos-enc's relative kernel
    (optionally cached) and --lappe's Laplacian eigenvectors."""
    if args.pos_enc:
        cache = PECache(cache_dir) if cache_dir else None
        cls = POSENCODINGS[args.pos_enc]
        if args.pos_enc == "diffusion":
            enc = cls(beta=args.beta, normalization=args.normalization,
                      cache=cache, zero_diag=args.zero_diag)
        elif args.pos_enc == "pstep":
            enc = cls(p=args.p, beta=args.beta,
                      normalization=args.normalization, cache=cache,
                      zero_diag=args.zero_diag)
        else:
            enc = cls(normalization=args.normalization, cache=cache,
                      zero_diag=args.zero_diag)
        enc.apply_to(graphs)
    if args.lappe:
        LapEncoding(args.lap_dim, normalization="sym").apply_to(graphs)
    return graphs


def make_batches(graphs: Sequence[Graph], batch_size: int,
                 max_nodes: Optional[int] = None,
                 shuffle_seed: Optional[int] = None,
                 node_labels: Optional[bool] = None) -> List[GraphBatch]:
    """Host batches of `batch_size` graphs padded to one node count (the
    bucket of the largest graph unless given), optionally in an order
    shuffled by `shuffle_seed`."""
    idx = np.arange(len(graphs))
    if shuffle_seed is not None:
        np.random.default_rng(shuffle_seed).shuffle(idx)
    if max_nodes is None:
        max_nodes = pad_bucket(max(g.num_nodes for g in graphs))
    return [collate_graphs([graphs[j] for j in idx[i:i + batch_size]],
                           max_nodes=max_nodes, node_labels=node_labels)
            for i in range(0, len(idx), batch_size)]


def print_row(row: dict) -> None:
    print({k: (round(v, 5) if isinstance(v, float) else v)
           for k, v in row.items()})


def run_and_log(trainer, train_b, val_b, test_b, args, outdir,
                extra_results=None, rebatch_fn=None,
                summary_keys=("best_epoch", "best_val")):
    """`trainer.fit` with the CLI's checkpoint flags; per-epoch rows to
    `outdir/logs.csv` (printed without an outdir) and the summary to
    `outdir/results.csv`: `summary_keys` of the fit's result, the test
    metrics and `extra_results`."""
    logger = CSVLogger(outdir) if outdir else None
    result = trainer.fit(
        train_b, val_batches=val_b, test_batches=test_b,
        epochs=args.epochs, rebatch_fn=rebatch_fn,
        log_fn=logger.log if logger else print_row,
        ckpt_dir=getattr(args, "ckpt_dir", None),
        resume=getattr(args, "resume", False))
    if logger:
        logger.flush("logs.csv")
        summary = {k: result[k] for k in summary_keys}
        if "test" in result:
            summary.update({f"test_{k}": v
                            for k, v in result["test"].items()})
        if extra_results:
            summary.update(extra_results)
        logger.write_results(summary)
    print("best_val:", result["best_val"], "test:", result.get("test"))
    return result
