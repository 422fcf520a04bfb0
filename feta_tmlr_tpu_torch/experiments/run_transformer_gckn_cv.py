"""GraphiT + GCKN path-kernel codes, TU graph classification with CV.

    python -m feta_tmlr_tpu_torch.experiments.run_transformer_gckn_cv \
        --datadir dataset --dataset NCI1 --fold-idx 1 [--device cpu]

GCKN codes through the Laplacian-PE input of the plain
`DiffGraphTransformer`; cross-entropy with StepLR(50, 0.5), the fold
files of --datadir/fold-idx when present. The JAX CLI's flags and
defaults (paths of 3 nodes). Synthetic learnable graphs when the dataset
is absent. The model runs on the "flash" attention route.
"""

from __future__ import annotations

import argparse

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
from feta_tmlr_tpu_torch.gckn.models import gckn_encode_as_pe
from feta_tmlr_tpu_torch.nn.models import DiffGraphTransformer
from feta_tmlr_tpu_torch.train.trainer import TrainConfig, Trainer


def main(argv=None):
    p = base_parser("NCI1")
    p.add_argument("--gckn-dim", type=int, default=32)
    p.add_argument("--gckn-path", type=int, default=3)
    p.add_argument("--n-sampling-paths", type=int, default=100000)
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    outdir = resolve_outdir(args, family="transformer_gckn")

    graphs, in_size, n_classes, _real = load_tu_or_synthetic(args)
    pe_dim = gckn_encode_as_pe(graphs, dim=args.gckn_dim,
                               path_size=args.gckn_path,
                               n_sampling_paths=args.n_sampling_paths,
                               seed=args.seed, device=device)
    apply_position_encodings(graphs, argparse.Namespace(
        **{**vars(args), "lappe": False}))
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
        batch_norm=args.batch_norm, lap_pos_enc=True,
        lap_pos_enc_dim=pe_dim, seed=args.seed, device=device)
    trainer = Trainer(
        model,
        TrainConfig(task="graph_clf", lr=args.lr,
                    weight_decay=args.weight_decay, epochs=args.epochs,
                    schedule="step", step_size=50, gamma=0.5,
                    sign_flip=False, seed=args.seed),
        steps_per_epoch=len(train_b))
    return run_and_log(trainer, train_b, test_b, test_b, args, outdir)


if __name__ == "__main__":
    main()
