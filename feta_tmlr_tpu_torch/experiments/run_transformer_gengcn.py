"""FeTA ZINC graph regression (`feta-torch-zinc`).

    python -m feta_tmlr_tpu_torch.experiments.run_transformer_gengcn \
        --datadir data --lappe --lap-dim 8 --ckpt-dir runs/zinc [--device cpu]

L1 loss, AdamW with the plateau schedule (or warmup with --warmup),
diffusion / p-step / adjacency PE and the Laplacian PE option, the JAX
CLI's flags and defaults (8 heads, 10 layers, width 64, batch norm unless
--layer-norm). Falls back to synthetic molecule-shaped graphs when the
ZINC pickles are absent. The model runs on the "flash" attention route.
`--packed` packs each batch of graphs into rows of 128 nodes
(`data/pack.py`) and trains `PackedDiffGraphTransformerGenGCN`
(`nn/packed.py`), whose layers take the plain pair-masked attention.
"""

from __future__ import annotations

from feta_tmlr_tpu_torch.data.pack import pack_graphs
from feta_tmlr_tpu_torch.device import resolve_device
from feta_tmlr_tpu_torch.experiments.common import (
    apply_position_encodings,
    base_parser,
    load_zinc_tier,
    make_batches,
    resolve_outdir,
    run_and_log,
)
from feta_tmlr_tpu_torch.nn.models import DiffGraphTransformerGenGCN
from feta_tmlr_tpu_torch.nn.packed import PackedDiffGraphTransformerGenGCN
from feta_tmlr_tpu_torch.train.trainer import TrainConfig, Trainer


def main(argv=None):
    p = base_parser("ZINC")
    p.add_argument("--packed", action="store_true",
                   help="pack ~5 graphs per 128-node row (nn/packed.py)")
    p.set_defaults(nb_heads=8, nb_layers=10, dim_hidden=64, lap_dim=8)
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    # ZINC-style scripts default to batch norm; --layer-norm switches
    args.batch_norm = not args.layer_norm
    outdir = resolve_outdir(args, family="transformer_gengcn_zinc")

    tr, va, te, in_size, _real = load_zinc_tier(args)
    graphs = tr + va + te
    apply_position_encodings(graphs, args)
    width = dict(in_size=in_size, nb_class=1, d_model=args.dim_hidden,
                 nb_heads=args.nb_heads, dim_feedforward=2 * args.dim_hidden,
                 dropout=args.dropout, nb_layers=args.nb_layers,
                 batch_norm=args.batch_norm, lap_pos_enc=args.lappe,
                 lap_pos_enc_dim=args.lap_dim,
                 filter_order=args.filter_order,
                 last_layer_filter=args.last_layer_filter, seed=args.seed,
                 device=device)
    if args.packed:
        # the JAX CLI's packed branch: batches in their file order, no
        # gnn_type (the packed encoder is the dynamic Chebyshev filter)
        pack = lambda gs: [pack_graphs(gs[i:i + args.batch_size],
                                       row_len=128)
                           for i in range(0, len(gs), args.batch_size)]
        train_b, val_b, test_b = pack(tr), pack(va), pack(te)
        model = PackedDiffGraphTransformerGenGCN(**width)
    else:
        max_nodes = max(g.num_nodes for g in graphs)
        train_b = make_batches(tr, args.batch_size, max_nodes,
                               shuffle_seed=args.seed)
        val_b = make_batches(va, args.batch_size, max_nodes)
        test_b = make_batches(te, args.batch_size, max_nodes)
        model = DiffGraphTransformerGenGCN(**width, gnn_type=args.gnn_type)
    trainer = Trainer(
        model,
        TrainConfig(task="graph_reg", lr=args.lr,
                    weight_decay=args.weight_decay, epochs=args.epochs,
                    regularization=args.regularization,
                    schedule=("warmup" if args.warmup else "plateau"),
                    warmup_steps=args.warmup or 2000,
                    # the reference ZINC plateau protocol
                    plateau_patience=15, plateau_factor=0.5, min_lr=1e-5,
                    sign_flip=args.lappe, seed=args.seed),
        steps_per_epoch=len(train_b))
    return run_and_log(trainer, train_b, val_b, test_b, args, outdir)

if __name__ == "__main__":
    main()
