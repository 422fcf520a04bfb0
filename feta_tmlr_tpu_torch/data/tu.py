"""TU-format graph datasets and their cross-validation folds.

Parses the standard TU text layout (1-indexed `_A.txt` edge list,
`_graph_indicator.txt` node -> graph map, `_graph_labels.txt`, optional
`_node_labels.txt` / `_node_attributes.txt`) into host graphs, as the
reference's gckn/data_io.py does:
  - node labels shifted to start at 0 and one-hot encoded as features;
  - graph labels remapped to ints in first-seen order;
  - 10-fold splits from the reference's
    `fold-idx/{name}/10fold_idx/{train,test}_idx-{fold}.txt` files when
    present, else a stratified split: `stratified_kfold` is scikit-learn's
    `StratifiedKFold(shuffle=True, random_state=seed)` algorithm in numpy
    (the card's machine has no scikit-learn), the same folds for a seed.
The same parse as the JAX package's pure-Python path (its optional C
tokenizer gives the same graphs).
"""

from __future__ import annotations

import os
import re
from typing import List, Optional, Tuple

import numpy as np

from feta_tmlr_tpu_torch.data.batch import Graph


def load_tu_dataset(
    name: str,
    datadir: str = "dataset",
    one_hot_labels: bool = True,
    degree_feature: bool = True,
) -> Tuple[List[Graph], int]:
    """Parse a TU dataset directory. Returns (graphs, n_node_tags)."""
    prefix = os.path.join(datadir, name, name)
    with open(prefix + "_graph_indicator.txt") as f:
        node2graph = np.array([int(l) for l in f if l.strip()])
    with open(prefix + "_graph_labels.txt") as f:
        raw_labels = [int(l) for l in f if l.strip()]
    # remap labels by first-seen order (data_io.py:80-89)
    label_map = {}
    for v in raw_labels:
        if v not in label_map:
            label_map[v] = len(label_map)
    graph_labels = np.array([label_map[v] for v in raw_labels])
    n_graphs = len(graph_labels)

    node_labels = None
    n_tags = 0
    path = prefix + "_node_labels.txt"
    if os.path.isfile(path):
        with open(path) as f:
            node_labels = np.array([int(l) for l in f if l.strip()])
        node_labels = node_labels - node_labels.min()
        n_tags = int(node_labels.max()) + 1

    node_attrs = None
    path = prefix + "_node_attributes.txt"
    if os.path.isfile(path):
        rows = []
        with open(path) as f:
            for line in f:
                vals = [float(a) for a in re.split(r"[,\s]+", line.strip())
                        if a]
                if vals:
                    rows.append(vals)
        node_attrs = np.asarray(rows, dtype=np.float32)

    pairs = []
    with open(prefix + "_A.txt") as f:
        for line in f:
            if not line.strip():
                continue
            a, b = line.replace(",", " ").split()[:2]
            pairs.append((int(a), int(b)))
    edges = np.asarray(pairs, dtype=np.int64).T  # [2, E], 1-indexed

    # group nodes per graph
    graphs: List[Graph] = []
    node_offsets = np.zeros(n_graphs + 1, dtype=np.int64)
    counts = np.bincount(node2graph, minlength=n_graphs + 1)
    node_offsets[1:] = np.cumsum(counts[1:])
    # edge membership by source node's graph (data_io.py:110-119)
    edge_graph = node2graph[edges[0] - 1]
    order = np.argsort(edge_graph, kind="stable")
    edges_sorted = edges[:, order]
    edge_graph_sorted = edge_graph[order]
    bounds = np.searchsorted(edge_graph_sorted, np.arange(1, n_graphs + 2))

    for gi in range(n_graphs):
        lo_node = node_offsets[gi]
        hi_node = node_offsets[gi + 1]
        m = hi_node - lo_node
        # edges of graph id gi+1 span [searchsorted(id), searchsorted(id+1))
        e_lo, e_hi = bounds[gi], bounds[gi + 1]
        e = edges_sorted[:, e_lo:e_hi] - 1 - lo_node  # to local 0-index
        if one_hot_labels and node_labels is not None:
            x = np.eye(n_tags, dtype=np.float32)[
                node_labels[lo_node:hi_node]]
        elif node_attrs is not None:
            x = node_attrs[lo_node:hi_node]
        else:
            x = np.ones((m, 1), dtype=np.float32)
        if node_attrs is not None and one_hot_labels and node_labels is not None:
            x = np.concatenate([x, node_attrs[lo_node:hi_node]], axis=-1)
        g = Graph(x=x, edge_index=e.astype(np.int32),
                  y=np.int64(graph_labels[gi]))
        if degree_feature:
            g.compute_degree_feature()
        graphs.append(g)
    return graphs, n_tags


def load_fold_indices(
    graphs: List[Graph],
    fold_idx: int,
    name: Optional[str] = None,
    fold_dir: Optional[str] = None,
    n_folds: int = 10,
    seed: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """(train_idx, test_idx) for a CV fold (1-based fold_idx as in README).

    Prefers the reference's on-disk `10fold_idx/{train,test}_idx-{fold}.txt`
    files; otherwise a stratified split matching gckn/data.py:167-180.
    """
    if fold_dir and name:
        base = os.path.join(fold_dir, name, f"{n_folds}fold_idx")
        tr = os.path.join(base, f"train_idx-{fold_idx}.txt")
        te = os.path.join(base, f"test_idx-{fold_idx}.txt")
        if os.path.isfile(tr) and os.path.isfile(te):
            return (np.loadtxt(tr, dtype=np.int64),
                    np.loadtxt(te, dtype=np.int64))
    labels = np.array([int(g.y) for g in graphs])
    return stratified_kfold(labels, n_folds, seed)[fold_idx - 1]


def stratified_kfold(labels: np.ndarray, n_folds: int, seed: int):
    """[(train_idx, test_idx)] of each fold: scikit-learn's
    StratifiedKFold(n_folds, shuffle=True, random_state=seed) algorithm.
    Each class's members, in index order, are dealt to the folds in the
    proportions of a round-robin over the label-sorted samples, the fold
    ids of each class shuffled by one RandomState(seed)."""
    rng = np.random.RandomState(seed)
    y = np.asarray(labels)
    _, y_idx, y_inv = np.unique(y, return_index=True, return_inverse=True)
    _, class_perm = np.unique(y_idx, return_inverse=True)
    y_encoded = class_perm[y_inv]
    n_classes = len(y_idx)
    if len(y) < n_folds or np.all(np.bincount(y_encoded) < n_folds):
        raise ValueError(f"{n_folds} folds: more than the samples or than "
                         "the members of every class")
    y_order = np.sort(y_encoded)
    allocation = np.asarray([
        np.bincount(y_order[i::n_folds], minlength=n_classes)
        for i in range(n_folds)])
    test_folds = np.empty(len(y), dtype="i")
    for k in range(n_classes):
        folds_for_class = np.arange(n_folds).repeat(allocation[:, k])
        rng.shuffle(folds_for_class)
        test_folds[y_encoded == k] = folds_for_class
    idx = np.arange(len(y))
    return [(idx[test_folds != f], idx[test_folds == f])
            for f in range(n_folds)]


def make_splits(n: int, n_folds: int = 10, seed: int = 0,
                test_ratio: float = 0.1):
    """Nested CV split generator (gckn/utils.py:164-191): yields
    (train_idx, val_idx, test_idx) per outer fold with an inner val split."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    fold_size = n // n_folds
    for f in range(n_folds):
        test = perm[f * fold_size:(f + 1) * fold_size]
        rest = np.concatenate([perm[: f * fold_size],
                               perm[(f + 1) * fold_size:]])
        n_val = max(int(len(rest) * test_ratio), 1)
        val, train = rest[:n_val], rest[n_val:]
        yield train, val, test
