"""FeTA + GCKN path-kernel codes, ZINC regression (`feta-torch-zinc-gckn`).

    python -m feta_tmlr_tpu_torch.experiments.run_transformer_gckn_gengcn \
        --datadir data --ckpt-dir runs/zinc_gckn [--device cpu]

A headline configuration of the paper. Unsupervised GCKN codes (paths of
up to --gckn-path nodes enumerated on the host, one path layer of
--gckn-dim anchors pretrained by spherical k-means over
--n-sampling-paths sampled paths, every graph encoded on the device,
codes standardised) enter `DiffGraphTransformerGenGCN` through its
Laplacian-PE input (lap_pos_enc_dim = --gckn-dim); L1 loss, AdamW with
the plateau schedule (or warmup with --warmup). The JAX CLI's flags and
defaults (paths of 8 nodes, sigma 0.6, sum pooling, 100,000 sampled
paths; 8 heads, 10 layers, width 64, batch norm unless --layer-norm). The
model runs on the "flash" attention route.
"""

from __future__ import annotations

import argparse

from feta_tmlr_tpu_torch.device import resolve_device
from feta_tmlr_tpu_torch.experiments.common import (
    apply_position_encodings,
    base_parser,
    load_zinc_tier,
    make_batches,
    resolve_outdir,
    run_and_log,
)
from feta_tmlr_tpu_torch.gckn.models import gckn_encode_as_pe
from feta_tmlr_tpu_torch.nn.models import DiffGraphTransformerGenGCN
from feta_tmlr_tpu_torch.train.trainer import TrainConfig, Trainer


def main(argv=None):
    p = base_parser("ZINC")
    p.add_argument("--gckn-dim", type=int, default=32)
    p.add_argument("--gckn-path", type=int, default=8)
    p.add_argument("--gckn-sigma", type=float, default=0.6)
    p.add_argument("--gckn-pooling", default="sum",
                   choices=["mean", "sum"])
    p.add_argument("--n-sampling-paths", type=int, default=100000)
    p.set_defaults(nb_heads=8, nb_layers=10, dim_hidden=64)
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    args.batch_norm = not args.layer_norm
    outdir = resolve_outdir(args, family="transformer_gckn_gengcn_zinc")

    tr, va, te, in_size, _real = load_zinc_tier(args)
    graphs = tr + va + te
    pe_dim = gckn_encode_as_pe(graphs, dim=args.gckn_dim,
                               path_size=args.gckn_path,
                               kernel_arg=args.gckn_sigma,
                               pooling=args.gckn_pooling,
                               n_sampling_paths=args.n_sampling_paths,
                               seed=args.seed, device=device)
    # the GCKN codes take the Laplacian PE's place
    apply_position_encodings(graphs, argparse.Namespace(
        **{**vars(args), "lappe": False}))
    max_nodes = max(g.num_nodes for g in graphs)
    train_b = make_batches(tr, args.batch_size, max_nodes,
                           shuffle_seed=args.seed)
    val_b = make_batches(va, args.batch_size, max_nodes)
    test_b = make_batches(te, args.batch_size, max_nodes)

    model = DiffGraphTransformerGenGCN(
        in_size=in_size, nb_class=1, d_model=args.dim_hidden,
        nb_heads=args.nb_heads, dim_feedforward=2 * args.dim_hidden,
        dropout=args.dropout, nb_layers=args.nb_layers,
        batch_norm=args.batch_norm, lap_pos_enc=True,
        lap_pos_enc_dim=pe_dim, filter_order=args.filter_order,
        gnn_type=args.gnn_type, last_layer_filter=args.last_layer_filter,
        seed=args.seed, device=device)
    trainer = Trainer(
        model,
        TrainConfig(task="graph_reg", lr=args.lr,
                    weight_decay=args.weight_decay, epochs=args.epochs,
                    regularization=args.regularization,
                    schedule=("warmup" if args.warmup else "plateau"),
                    warmup_steps=args.warmup or 2000,
                    # the reference ZINC plateau protocol
                    plateau_patience=15, plateau_factor=0.5, min_lr=1e-5,
                    sign_flip=False, seed=args.seed),
        steps_per_epoch=len(train_b))
    return run_and_log(trainer, train_b, val_b, test_b, args, outdir)


if __name__ == "__main__":
    main()
