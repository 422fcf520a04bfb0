"""Synthetic SBM-shaped graphs (PATTERN/CLUSTER-like) for tests and the
chip smoke run. The numpy call sequence is the JAX package's, so a seed
gives identical graphs in both."""

from __future__ import annotations

from typing import List

import numpy as np

from feta_tmlr_tpu_torch.data.batch import Graph


def sbm_like_dataset(seed: int = 0, n_graphs: int = 8, n_nodes: int = 128,
                     n_classes: int = 2) -> List[Graph]:
    """Dense-ish two-probability blocks, one-hot features of width 3,
    per-node labels; sizes vary by up to n_nodes/8 below n_nodes."""
    rng = np.random.default_rng(seed)
    graphs = []
    for _ in range(n_graphs):
        n_g = max(4, n_nodes - int(rng.integers(0, max(n_nodes // 8, 2))))
        labels = rng.integers(0, n_classes, size=n_g)
        p_in, p_out = 0.2, 0.05
        probs = np.where(labels[:, None] == labels[None, :], p_in, p_out)
        upper = np.triu(rng.random((n_g, n_g)) < probs, k=1)
        rows, cols = np.nonzero(upper)
        edge_index = np.stack(
            [np.concatenate([rows, cols]), np.concatenate([cols, rows])]
        ).astype(np.int32)
        x = np.eye(3, dtype=np.float32)[rng.integers(0, 3, size=n_g)]
        g = Graph(x=x, edge_index=edge_index, y=labels.astype(np.int32))
        g.compute_degree_feature()
        graphs.append(g)
    return graphs
