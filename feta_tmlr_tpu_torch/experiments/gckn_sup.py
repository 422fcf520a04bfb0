"""Supervised GCKN, ZINC-style graph regression.

    python -m feta_tmlr_tpu_torch.experiments.gckn_sup [--device cpu]

`GCKNSupervised`: its path layer pretrained by spherical k-means, then the
whole network (path layer, normalisation, linear head) trained end to end
by Adam on the L1 loss over the training split as one batch, printing
the loss and the test MAE (normalised by the training split's statistics)
every 10 epochs. The JAX CLI's flags and defaults (paths of 4 nodes,
hidden 32, sigma 0.5, sum pooling, 300 epochs, lr 1e-3) on its data:
synthetic molecule-shaped graphs, 80 % for training.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from feta_tmlr_tpu_torch.data.synthetic import zinc_like_dataset
from feta_tmlr_tpu_torch.device import resolve_device
from feta_tmlr_tpu_torch.experiments.common import add_device_flag
from feta_tmlr_tpu_torch.gckn.models import GCKNSupervised
from feta_tmlr_tpu_torch.gckn.paths import build_path_batch
from feta_tmlr_tpu_torch.train.metrics import mae


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--path-size", type=int, default=4)
    p.add_argument("--hidden-size", type=int, default=32)
    p.add_argument("--sigma", type=float, default=0.5)
    p.add_argument("--pooling", type=str, default="sum")
    p.add_argument("--aggregation", action="store_true")
    p.add_argument("--epochs", type=int, default=300)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--n-sampling-paths", type=int, default=100000)
    p.add_argument("--synthetic-graphs", type=int, default=96)
    add_device_flag(p)
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    print("[warn] ZINC files not bundled - synthetic molecule fallback")
    graphs = zinc_like_dataset(seed=args.seed,
                               n_graphs=args.synthetic_graphs)
    n = len(graphs)
    tr = graphs[: int(0.8 * n)]
    te = graphs[int(0.8 * n):]

    model = GCKNSupervised(
        input_size=tr[0].x.shape[-1], hidden_sizes=[args.hidden_size],
        path_sizes=[args.path_size], n_classes=1,
        kernel_args=args.sigma, pooling=args.pooling,
        aggregation=args.aggregation, seed=args.seed, device=device)
    model.unsup_init(tr, args.n_sampling_paths, seed=args.seed)

    tb = build_path_batch(tr, model.feature.max_path_size)
    eb = build_path_batch(te, model.feature.max_path_size)
    y_tr = torch.tensor([float(g.y) for g in tr], device=device)
    y_te = np.asarray([float(g.y) for g in te])
    opt = torch.optim.Adam(model.parameters(), lr=args.lr)

    def test_mae():
        bn_stats = model.compute_bn_stats(tb)
        with torch.no_grad():
            pred = model(eb, bn_stats)[:, 0].cpu().numpy()
        return mae(pred, y_te)

    for epoch in range(args.epochs):
        opt.zero_grad()
        loss = torch.abs(model(tb)[:, 0] - y_tr).mean()  # L1, the reference's
        loss.backward()
        opt.step()
        if epoch % 10 == 0 or epoch == args.epochs - 1:
            print({"epoch": epoch, "loss": round(loss.item(), 5),
                   "test_mae": round(test_mae(), 4)})
    return test_mae()


if __name__ == "__main__":
    main()
