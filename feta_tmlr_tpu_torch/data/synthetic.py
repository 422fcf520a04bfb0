"""Synthetic graphs for tests and the chip smoke run: graphs with a
learnable label (the TU CLIs' fallback), SBM-shaped node
classification graphs (PATTERN/CLUSTER-like), ZINC-shaped molecules with
one-hot atoms, ZINC-shaped molecules with categorical atoms and bonds, and
OGB-shaped molecules (the molhiv / molpcba CLIs' fallback).
The numpy call sequence is the JAX package's, so a seed gives identical
graphs in both."""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from feta_tmlr_tpu_torch.data.batch import Graph
from feta_tmlr_tpu_torch.data.ogb_raw import ATOM_FEATURE_DIMS


def random_connected_graph(rng: np.random.Generator, n_nodes: int,
                           n_features: int, edge_prob: float = 0.2,
                           node_classes: Optional[int] = None) -> Graph:
    """Random undirected graph: a spanning chain plus Erdos-Renyi edges
    (so it is connected); one-hot class features or Gaussian ones."""
    upper = np.triu(rng.random((n_nodes, n_nodes)) < edge_prob, k=1)
    for i in range(n_nodes - 1):
        upper[i, i + 1] = True
    rows, cols = np.nonzero(upper)
    edge_index = np.stack([np.concatenate([rows, cols]),
                           np.concatenate([cols, rows])]).astype(np.int32)
    if node_classes is not None:
        labels = rng.integers(0, node_classes, size=n_nodes)
        x = np.eye(n_features, dtype=np.float32)[labels % n_features]
    else:
        x = rng.standard_normal((n_nodes, n_features)).astype(np.float32)
    return Graph(x=x, edge_index=edge_index)


def random_graph_dataset(seed: int = 0, n_graphs: int = 32,
                         min_nodes: int = 6, max_nodes: int = 24,
                         n_features: int = 7, n_classes: int = 2,
                         edge_prob: float = 0.2,
                         task: str = "classification",
                         node_level: bool = False) -> List[Graph]:
    """Graphs of min_nodes..max_nodes nodes with Gaussian features and a
    label a model can fit: per node, degree above the graph's median
    (node_level); a float of the mean degree and features (task other
    than classification); else a balanced class, a median split of mean
    degree plus 0.3 times the mean feature."""
    rng = np.random.default_rng(seed)
    graphs, scores = [], []
    for _ in range(n_graphs):
        n = int(rng.integers(min_nodes, max_nodes + 1))
        g = random_connected_graph(rng, n, n_features, edge_prob)
        mean_deg = g.num_edges / n
        scores.append(mean_deg + 0.3 * float(g.x.mean()))
        if node_level:
            deg = np.zeros(n)
            np.add.at(deg, g.edge_index[0], 1.0)
            g.y = (deg > np.median(deg)).astype(np.int32)
        elif task != "classification":
            g.y = np.float32(mean_deg + 0.1 * g.x.sum())
        g.compute_degree_feature()
        graphs.append(g)
    if not node_level and task == "classification":
        med = float(np.median(scores))
        for g, s in zip(graphs, scores):
            g.y = np.int64(s > med)
    return graphs


def zinc_like_dataset(seed: int = 0, n_graphs: int = 128) -> List[Graph]:
    """Molecule-shaped graphs of 9-37 nodes (ZINC: ~23 on average) with
    one-hot features over 28 atom types and a float regression target."""
    rng = np.random.default_rng(seed)
    graphs = []
    for _ in range(n_graphs):
        n = int(rng.integers(9, 38))
        g = random_connected_graph(rng, n, 28, edge_prob=2.0 / max(n - 1, 1),
                                   node_classes=28)
        g.y = np.float32(rng.standard_normal())
        g.compute_degree_feature()
        graphs.append(g)
    return graphs


def zinc_categorical_dataset(seed: int = 0, n_graphs: int = 32,
                             num_atom_type: int = 28,
                             num_bond_type: int = 4) -> List[Graph]:
    """ZINC-shaped molecules of 9-29 atoms: int atom ids as node features
    [n, 1], symmetric int bond types in 1..num_bond_type-1 per edge, and a
    float regression target."""
    rng = np.random.default_rng(seed)
    graphs = []
    for _ in range(n_graphs):
        n = int(rng.integers(9, 30))
        g = random_connected_graph(rng, n, 1, edge_prob=2.0 / max(n - 1, 1))
        g.x = rng.integers(0, num_atom_type, size=(n, 1)).astype(np.int32)
        et = np.zeros(g.num_edges, dtype=np.int32)
        seen = {}
        for i in range(g.num_edges):
            key = tuple(sorted((int(g.edge_index[0, i]),
                                int(g.edge_index[1, i]))))
            if key not in seen:
                seen[key] = int(rng.integers(1, num_bond_type))
            et[i] = seen[key]
        g.edge_type = et
        g.y = np.float32(rng.standard_normal())
        g.compute_degree_feature()
        graphs.append(g)
    return graphs


def ogb_like_dataset(seed: int = 0, n_graphs: int = 128,
                     n_tasks: int = 1) -> List[Graph]:
    """Molecule-shaped graphs of 8-27 atoms with the nine OGB atom feature
    columns (ints in each column's vocabulary) and binary labels: a scalar
    for one task (molhiv), else [n_tasks]. The molhiv CLI's synthetic
    fallback (experiments/run_transformer_gengcn_molhiv.py:26-38)."""
    rng = np.random.default_rng(seed)
    graphs = []
    for _ in range(n_graphs):
        n = int(rng.integers(8, 28))
        g = random_connected_graph(rng, n, 1, edge_prob=0.15)
        g.x = np.stack([rng.integers(0, d, n) for d in ATOM_FEATURE_DIMS],
                       axis=-1).astype(np.int32)
        g.y = (np.float32(rng.integers(0, 2)) if n_tasks == 1
               else rng.integers(0, 2, n_tasks).astype(np.float32))
        g.compute_degree_feature()
        graphs.append(g)
    return graphs


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
