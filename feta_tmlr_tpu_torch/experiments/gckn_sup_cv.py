"""Supervised GCKN, TU graph classification with CV.

    python -m feta_tmlr_tpu_torch.experiments.gckn_sup_cv \
        --datadir dataset --dataset MUTAG --fold-idx 1 [--device cpu]

`GCKNSupervised`: its path layer pretrained by spherical k-means over all
graphs, then trained end to end by Adam on the cross-entropy over the
fold's training graphs as one batch, printing the loss and the test
accuracy (the test batch normalised by its own statistics, as the JAX
CLI) every 10 epochs. The JAX CLI's flags and defaults (paths of 3 nodes,
hidden 32, sigma 0.5, mean pooling, 100 epochs, lr 0.01); synthetic
graphs with 7 features when the dataset is absent.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from feta_tmlr_tpu_torch.data.synthetic import random_graph_dataset
from feta_tmlr_tpu_torch.data.tu import load_fold_indices, load_tu_dataset
from feta_tmlr_tpu_torch.device import resolve_device
from feta_tmlr_tpu_torch.experiments.common import add_device_flag
from feta_tmlr_tpu_torch.gckn.models import GCKNSupervised
from feta_tmlr_tpu_torch.gckn.paths import build_path_batch
from feta_tmlr_tpu_torch.train.metrics import accuracy_graph


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--dataset", type=str, default="MUTAG")
    p.add_argument("--datadir", type=str, default="dataset")
    p.add_argument("--path-size", type=int, default=3)
    p.add_argument("--hidden-size", type=int, default=32)
    p.add_argument("--sigma", type=float, default=0.5)
    p.add_argument("--pooling", type=str, default="mean")
    p.add_argument("--aggregation", action="store_true")
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--lr", type=float, default=0.01)
    p.add_argument("--fold-idx", type=int, default=1)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--n-sampling-paths", type=int, default=100000)
    p.add_argument("--synthetic-graphs", type=int, default=80)
    add_device_flag(p)
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    path = os.path.join(args.datadir, args.dataset)
    if os.path.isdir(path):
        graphs, _ = load_tu_dataset(args.dataset, args.datadir)
    else:
        print(f"[warn] {path} not found - synthetic fallback")
        graphs = random_graph_dataset(seed=args.seed,
                                      n_graphs=args.synthetic_graphs,
                                      n_features=7)
    n_classes = len({int(g.y) for g in graphs})
    tr_idx, te_idx = load_fold_indices(
        graphs, args.fold_idx, name=args.dataset,
        fold_dir=f"{args.datadir}/fold-idx", seed=args.seed)

    model = GCKNSupervised(
        input_size=graphs[0].x.shape[-1],
        hidden_sizes=[args.hidden_size], path_sizes=[args.path_size],
        n_classes=n_classes, kernel_args=args.sigma,
        pooling=args.pooling, aggregation=args.aggregation, seed=args.seed,
        device=device)
    model.unsup_init(graphs, args.n_sampling_paths, seed=args.seed)

    train_graphs = [graphs[i] for i in tr_idx]
    test_graphs = [graphs[i] for i in te_idx]
    tb = build_path_batch(train_graphs, model.feature.max_path_size)
    eb = build_path_batch(test_graphs, model.feature.max_path_size)
    y_tr = torch.tensor([int(g.y) for g in train_graphs], device=device)
    y_te = np.asarray([int(g.y) for g in test_graphs])
    opt = torch.optim.Adam(model.parameters(), lr=args.lr)

    def test_acc():
        with torch.no_grad():
            return accuracy_graph(model(eb).cpu().numpy(), y_te)

    for epoch in range(args.epochs):
        opt.zero_grad()
        loss = torch.nn.functional.cross_entropy(model(tb), y_tr)
        loss.backward()
        opt.step()
        if epoch % 10 == 0 or epoch == args.epochs - 1:
            print({"epoch": epoch, "loss": round(loss.item(), 5),
                   "test_acc": round(test_acc(), 4)})
    return test_acc()


if __name__ == "__main__":
    main()
