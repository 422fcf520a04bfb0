"""Plain GraphiT TU graph classification, one fold.

    python -m feta_tmlr_tpu_torch.experiments.run_transformer_cv \
        --dataset MUTAG --datadir dataset [--device cpu]

`DiffGraphTransformer` (kernel-modulated attention, no spectral filter)
on one fold of the TU graph classification protocol: the stratified fold
split (the on-disk fold-idx files when present), cross-entropy, AdamW
with StepLR(50, 0.5), the test fold as the validation split. Reads the TU text layout under --datadir/--dataset;
falls back to synthetic learnable graphs when it is absent. The model runs
on the "flash" attention route.
"""

from __future__ import annotations

from feta_tmlr_tpu_torch.data.tu import load_fold_indices
from feta_tmlr_tpu_torch.device import resolve_device
from feta_tmlr_tpu_torch.experiments.common import (
    apply_position_encodings,
    base_parser,
    load_tu_or_synthetic,
    make_batches,
    resolve_outdir,
    run_and_log,
)
from feta_tmlr_tpu_torch.nn.models import DiffGraphTransformer
from feta_tmlr_tpu_torch.train.trainer import TrainConfig, Trainer


def main(argv=None):
    args = base_parser("NCI1").parse_args(argv)
    device = resolve_device(args.device)
    outdir = resolve_outdir(args, family="transformer_plain")
    graphs, in_size, n_classes, _real = load_tu_or_synthetic(args)
    apply_position_encodings(graphs, args)
    tr_idx, te_idx = load_fold_indices(
        graphs, args.fold_idx, name=args.dataset,
        fold_dir=f"{args.datadir}/fold-idx", seed=args.seed)
    max_nodes = max(g.num_nodes for g in graphs)
    train_b = make_batches([graphs[i] for i in tr_idx], args.batch_size,
                           max_nodes, shuffle_seed=args.seed)
    test_b = make_batches([graphs[i] for i in te_idx], args.batch_size,
                          max_nodes)
    model = DiffGraphTransformer(
        in_size=in_size, nb_class=n_classes, d_model=args.dim_hidden,
        nb_heads=args.nb_heads, dim_feedforward=2 * args.dim_hidden,
        dropout=args.dropout, nb_layers=args.nb_layers,
        batch_norm=args.batch_norm, lap_pos_enc=args.lappe,
        lap_pos_enc_dim=args.lap_dim, seed=args.seed, device=device)
    trainer = Trainer(
        model,
        TrainConfig(task="graph_clf", lr=args.lr,
                    weight_decay=args.weight_decay, epochs=args.epochs,
                    schedule="step", step_size=50, gamma=0.5,
                    sign_flip=args.lappe, seed=args.seed),
        steps_per_epoch=len(train_b))
    return run_and_log(trainer, train_b, test_b, test_b, args, outdir)


if __name__ == "__main__":
    main()
