"""Plain GraphiT SBM node classification, PATTERN / CLUSTER.

    python -m feta_tmlr_tpu_torch.experiments.run_transformer_SBM_cv \
        --datadir data --dataset PATTERN --ckpt-dir runs/sbm [--device cpu]

`DiffGraphTransformerSBM` (kernel-modulated attention, no spectral
filter, per-node logits) with per-node cross-entropy, class-balanced
accuracy and the JAX CLI's flags and defaults (batch 64, graphs of 96
nodes in the synthetic fallback used when the GNNBenchmark pickles are
absent). The model runs on the "flash" attention route.
"""

from __future__ import annotations

from feta_tmlr_tpu_torch.device import resolve_device
from feta_tmlr_tpu_torch.experiments.common import (
    apply_position_encodings,
    base_parser,
    load_sbm_tier,
    make_batches,
    resolve_outdir,
    run_and_log,
)
from feta_tmlr_tpu_torch.nn.models import DiffGraphTransformerSBM
from feta_tmlr_tpu_torch.train.trainer import TrainConfig, Trainer


def main(argv=None):
    p = base_parser("PATTERN")
    p.add_argument("--n-nodes", type=int, default=96)
    p.set_defaults(batch_size=64, synthetic_graphs=64)
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    outdir = resolve_outdir(args, family="transformer_sbm")

    tr, va, te, in_size, n_classes, _real = load_sbm_tier(args)
    graphs = tr + va + te
    apply_position_encodings(graphs, args)
    max_nodes = max(g.num_nodes for g in graphs)
    train_b = make_batches(tr, args.batch_size, max_nodes,
                           shuffle_seed=args.seed, node_labels=True)
    val_b = make_batches(va, args.batch_size, max_nodes, node_labels=True)
    test_b = make_batches(te, args.batch_size, max_nodes, node_labels=True)

    model = DiffGraphTransformerSBM(
        in_size=in_size, nb_class=n_classes, d_model=args.dim_hidden,
        nb_heads=args.nb_heads, dim_feedforward=2 * args.dim_hidden,
        dropout=args.dropout, nb_layers=args.nb_layers,
        batch_norm=args.batch_norm, lap_pos_enc=args.lappe,
        lap_pos_enc_dim=args.lap_dim, seed=args.seed, device=device)
    trainer = Trainer(
        model,
        TrainConfig(task="node_clf", lr=args.lr,
                    weight_decay=args.weight_decay, epochs=args.epochs,
                    sign_flip=args.lappe, seed=args.seed),
        steps_per_epoch=len(train_b))
    return run_and_log(trainer, train_b, val_b, test_b, args, outdir)


if __name__ == "__main__":
    main()
