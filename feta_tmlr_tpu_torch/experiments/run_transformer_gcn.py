"""GraphiT + a GCN after the last layer, ZINC graph regression.

    python -m feta_tmlr_tpu_torch.experiments.run_transformer_gcn \
        --datadir data --lappe --pos-enc diffusion \
        --ckpt-dir runs/graphit_gcn [--device cpu]

`DiffGraphTransformerGCN` (kernel-modulated attention, then a GCN over
the graph; the mean pool of the layers' output plus the max pool of
ReLU(GCN)) with the protocol and defaults of `run_transformer.py`. Falls
back to synthetic molecule-shaped graphs when the ZINC pickles are
absent. The model runs on the "flash" attention route.
"""

from __future__ import annotations

from feta_tmlr_tpu_torch.device import resolve_device
from feta_tmlr_tpu_torch.experiments.common import (
    apply_position_encodings,
    base_parser,
    load_zinc_tier,
    make_batches,
    resolve_outdir,
    run_and_log,
)
from feta_tmlr_tpu_torch.nn.models import DiffGraphTransformerGCN
from feta_tmlr_tpu_torch.train.trainer import TrainConfig, Trainer


def main(argv=None):
    p = base_parser("ZINC")
    p.set_defaults(nb_heads=8, nb_layers=10, dim_hidden=64, lap_dim=8)
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    args.batch_norm = not args.layer_norm
    outdir = resolve_outdir(args, family="transformer_gcn_zinc")

    tr, va, te, in_size, _real = load_zinc_tier(args)
    graphs = tr + va + te
    apply_position_encodings(graphs, args)
    max_nodes = max(g.num_nodes for g in graphs)
    train_b = make_batches(tr, args.batch_size, max_nodes,
                           shuffle_seed=args.seed)
    val_b = make_batches(va, args.batch_size, max_nodes)
    test_b = make_batches(te, args.batch_size, max_nodes)

    model = DiffGraphTransformerGCN(
        in_size=in_size, nb_class=1, d_model=args.dim_hidden,
        nb_heads=args.nb_heads, dim_feedforward=2 * args.dim_hidden,
        dropout=args.dropout, nb_layers=args.nb_layers,
        batch_norm=args.batch_norm, lap_pos_enc=args.lappe,
        lap_pos_enc_dim=args.lap_dim, seed=args.seed, device=device)
    trainer = Trainer(
        model,
        TrainConfig(task="graph_reg", lr=args.lr,
                    weight_decay=args.weight_decay, epochs=args.epochs,
                    schedule=("warmup" if args.warmup else "plateau"),
                    warmup_steps=args.warmup or 2000,
                    plateau_patience=15, plateau_factor=0.5, min_lr=1e-5,
                    sign_flip=args.lappe, seed=args.seed),
        steps_per_epoch=len(train_b))
    return run_and_log(trainer, train_b, val_b, test_b, args, outdir)


if __name__ == "__main__":
    main()
