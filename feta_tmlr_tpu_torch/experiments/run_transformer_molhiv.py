"""Plain GraphiT on ogbg-molhiv: ROC-AUC, sigmoid BCE loss.

    python -m feta_tmlr_tpu_torch.experiments.run_transformer_molhiv \
        --datadir dataset --ckpt-dir runs/graphit_molhiv [--device cpu]

`DiffGraphTransformerMolHiv` (the OGB atom encoder, kernel-modulated
attention, no spectral filter) with the JAX CLI's flags and defaults
(batch 128, width 128, 8 heads, 4 layers). Reads the raw OGB layout under
--datadir; falls back to synthetic OGB-shaped molecules when it is absent.
The model runs on the "flash" attention route, whose unfolded kernels take
width 128 (the fused pair and the folded kernels take 64 at most).
"""

from __future__ import annotations

from feta_tmlr_tpu_torch.data.synthetic import ogb_like_dataset
from feta_tmlr_tpu_torch.device import resolve_device
from feta_tmlr_tpu_torch.experiments.common import (
    apply_position_encodings,
    base_parser,
    load_ogb_tier,
    make_batches,
    resolve_outdir,
    run_and_log,
)
from feta_tmlr_tpu_torch.nn.models import DiffGraphTransformerMolHiv
from feta_tmlr_tpu_torch.train.trainer import TrainConfig, Trainer


def main(argv=None):
    p = base_parser("ogbg-molhiv")
    p.set_defaults(batch_size=128, dim_hidden=128, nb_heads=8, nb_layers=4)
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    outdir = resolve_outdir(args, family="transformer_molhiv")

    tr, va, te, _real = load_ogb_tier(
        args, "ogbg-molhiv",
        lambda: ogb_like_dataset(args.seed, args.synthetic_graphs))
    graphs = tr + va + te
    apply_position_encodings(graphs, args)
    max_nodes = max(g.num_nodes for g in graphs)
    train_b = make_batches(tr, args.batch_size, max_nodes,
                           shuffle_seed=args.seed)
    val_b = make_batches(va, args.batch_size, max_nodes)
    test_b = make_batches(te, args.batch_size, max_nodes)

    model = DiffGraphTransformerMolHiv(
        d_model=args.dim_hidden, nb_heads=args.nb_heads,
        dim_feedforward=2 * args.dim_hidden, dropout=args.dropout,
        nb_layers=args.nb_layers, batch_norm=args.batch_norm,
        lap_pos_enc=args.lappe, lap_pos_enc_dim=args.lap_dim,
        seed=args.seed, device=device)
    trainer = Trainer(
        model,
        TrainConfig(task="binary_graph", lr=args.lr,
                    weight_decay=args.weight_decay, epochs=args.epochs,
                    schedule=("warmup" if args.warmup else "constant"),
                    warmup_steps=args.warmup or 2000,
                    binary_metric="rocauc",
                    sign_flip=args.lappe, seed=args.seed),
        steps_per_epoch=len(train_b))
    return run_and_log(trainer, train_b, val_b, test_b, args, outdir)


if __name__ == "__main__":
    main()
