"""GraphiT + GCKN path-kernel codes, SBM node classification (PATTERN /
CLUSTER).

    python -m feta_tmlr_tpu_torch.experiments.run_transformer_gckn_SBM_cv \
        --datadir data --dataset PATTERN [--device cpu]

GCKN codes through the Laplacian-PE input of `DiffGraphTransformerSBM`
(kernel-modulated attention, no spectral filter, per-node logits);
per-node cross-entropy, class-balanced accuracy. The JAX CLI's flags and
defaults (batch 64, paths of 3 nodes, graphs of 96 nodes in the synthetic
fallback used when the GNNBenchmark pickles are absent). The model runs
on the "flash" attention route.
"""

from __future__ import annotations

import argparse

from feta_tmlr_tpu_torch.device import resolve_device
from feta_tmlr_tpu_torch.experiments.common import (
    apply_position_encodings,
    base_parser,
    load_sbm_tier,
    make_batches,
    resolve_outdir,
    run_and_log,
)
from feta_tmlr_tpu_torch.gckn.models import gckn_encode_as_pe
from feta_tmlr_tpu_torch.nn.models import DiffGraphTransformerSBM
from feta_tmlr_tpu_torch.train.trainer import TrainConfig, Trainer


def main(argv=None):
    p = base_parser("PATTERN")
    p.add_argument("--n-nodes", type=int, default=96)
    p.add_argument("--gckn-dim", type=int, default=32)
    p.add_argument("--gckn-path", type=int, default=3)
    p.add_argument("--n-sampling-paths", type=int, default=100000)
    p.set_defaults(batch_size=64, synthetic_graphs=64)
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    outdir = resolve_outdir(args, family="transformer_gckn_sbm")

    tr, va, te, in_size, n_classes, _real = load_sbm_tier(args)
    graphs = tr + va + te
    pe_dim = gckn_encode_as_pe(graphs, dim=args.gckn_dim,
                               path_size=args.gckn_path,
                               n_sampling_paths=args.n_sampling_paths,
                               seed=args.seed, device=device)
    apply_position_encodings(graphs, argparse.Namespace(
        **{**vars(args), "lappe": False}))
    max_nodes = max(g.num_nodes for g in graphs)
    train_b = make_batches(tr, args.batch_size, max_nodes,
                           shuffle_seed=args.seed, node_labels=True)
    val_b = make_batches(va, args.batch_size, max_nodes, node_labels=True)
    test_b = make_batches(te, args.batch_size, max_nodes, node_labels=True)

    model = DiffGraphTransformerSBM(
        in_size=in_size, nb_class=n_classes, d_model=args.dim_hidden,
        nb_heads=args.nb_heads, dim_feedforward=2 * args.dim_hidden,
        dropout=args.dropout, nb_layers=args.nb_layers,
        batch_norm=args.batch_norm, lap_pos_enc=True,
        lap_pos_enc_dim=pe_dim, seed=args.seed, device=device)
    trainer = Trainer(
        model,
        TrainConfig(task="node_clf", lr=args.lr,
                    weight_decay=args.weight_decay, epochs=args.epochs,
                    sign_flip=False, seed=args.seed),
        steps_per_epoch=len(train_b))
    return run_and_log(trainer, train_b, val_b, test_b, args, outdir)


if __name__ == "__main__":
    main()
