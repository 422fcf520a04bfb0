"""The OGB graph-property-prediction datasets read from their raw CSV
layout, with no `ogb` package:

  <root>/<ogbg_molhiv>/raw/edge.csv.gz            rows "src,dst", node ids
                                                  local to each graph,
                                                  graphs concatenated
                       num-node-list.csv.gz       one row per graph
                       num-edge-list.csv.gz       one row per graph
                       node-feat.csv.gz           [N_total, 9] int atom
                                                  features
                       edge-feat.csv.gz           [E_total, 3] int bond
                                                  features
                       graph-label.csv.gz         [G, n_tasks]; an empty
                                                  cell is unlabelled (NaN,
                                                  molpcba)
  <root>/<ogbg_molhiv>/split/<scheme>/{train,valid,test}.csv.gz

Plain `.csv` files are read as well. Each graph comes back as the port's
`Graph`: x the [n, 9] int32 atom features (the OGB atom encoder embeds all
nine), edge_attr the [e, 3] int32 bond features, edge_type the bond type
(their first column) + 1 so that 0 stays "no edge" in dense maps, and the
degree feature. The same reader as the JAX package's `data/ogb_raw.py`,
graph for graph.
"""

from __future__ import annotations

import gzip
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from feta_tmlr_tpu_torch.data.batch import Graph

# the vocabulary of each atom and bond feature column: ogb.utils.features'
# get_atom_feature_dims() and get_bond_feature_dims()
ATOM_FEATURE_DIMS = (119, 4, 12, 12, 10, 6, 6, 2, 2)
BOND_FEATURE_DIMS = (5, 6, 2)


def _open(path: str):
    if os.path.exists(path + ".gz"):
        return gzip.open(path + ".gz", "rt")
    return open(path, "rt")


def _exists(path: str) -> bool:
    return os.path.exists(path) or os.path.exists(path + ".gz")


def _read_csv(path: str, dtype=np.int64) -> np.ndarray:
    """A CSV of numbers; empty (or "nan") cells become NaN, which makes the
    result float32."""
    rows = []
    has_nan = False
    with _open(path) as f:
        for line in f:
            line = line.rstrip("\n")
            if not line:
                continue
            cells = line.split(",")
            if any(c in ("", "nan") for c in cells):
                has_nan = True
            rows.append([np.nan if c in ("", "nan") else float(c)
                         for c in cells])
    arr = np.asarray(rows, dtype=np.float64)
    if not has_nan and np.issubdtype(dtype, np.integer):
        return arr.astype(dtype)
    return arr.astype(np.float32)


def dataset_dir_name(name: str) -> str:
    """'ogbg-molhiv' -> 'ogbg_molhiv' (OGB's directory convention)."""
    return name.replace("-", "_").lower()


def load_ogb_graphs(root: str, name: str,
                    max_graphs: Optional[int] = None) -> List[Graph]:
    """Every graph of an OGB dataset (the first `max_graphs`), from its raw
    CSV directory."""
    raw = os.path.join(root, dataset_dir_name(name), "raw")
    if not os.path.isdir(raw):
        raise FileNotFoundError(raw)
    num_nodes = _read_csv(os.path.join(raw, "num-node-list.csv")).reshape(-1)
    num_edges = _read_csv(os.path.join(raw, "num-edge-list.csv")).reshape(-1)
    edges = _read_csv(os.path.join(raw, "edge.csv"))
    node_feat = _read_csv(os.path.join(raw, "node-feat.csv"))
    edge_feat = (_read_csv(os.path.join(raw, "edge-feat.csv"))
                 if _exists(os.path.join(raw, "edge-feat.csv")) else None)
    labels = np.atleast_2d(_read_csv(os.path.join(raw, "graph-label.csv"),
                                     dtype=np.float64).astype(np.float32))
    if labels.shape[0] == 1 and len(num_nodes) > 1:
        labels = labels.T
    num_nodes = num_nodes.astype(np.int64)
    num_edges = num_edges.astype(np.int64)
    if edges.ndim == 1:
        edges = edges.reshape(-1, 2)
    count = len(num_nodes) if max_graphs is None else min(len(num_nodes),
                                                          max_graphs)
    graphs: List[Graph] = []
    n_off = e_off = 0
    for gi in range(count):
        n, e = int(num_nodes[gi]), int(num_edges[gi])
        g = Graph(x=node_feat[n_off: n_off + n].astype(np.int32),
                  edge_index=edges[e_off: e_off + e].astype(np.int32).T,
                  y=labels[gi, 0] if labels.shape[1] == 1 else labels[gi])
        if edge_feat is not None:
            g.edge_attr = edge_feat[e_off: e_off + e].astype(np.int32)
            g.edge_type = ((g.edge_attr[:, 0] + 1).astype(np.int32) if e
                           else np.zeros(0, np.int32))
        g.compute_degree_feature()
        graphs.append(g)
        n_off += n
        e_off += e
    return graphs


def load_ogb_split_idx(root: str, name: str,
                       scheme: str = "scaffold") -> Dict[str, np.ndarray]:
    """{train, valid, test} -> graph indices from split/<scheme>/ (or the
    one scheme a dataset ships, where it has no `scheme`)."""
    split_dir = os.path.join(root, dataset_dir_name(name), "split", scheme)
    if not os.path.isdir(split_dir):
        parent = os.path.join(root, dataset_dir_name(name), "split")
        subs = sorted(os.listdir(parent)) if os.path.isdir(parent) else []
        if not subs:
            raise FileNotFoundError(split_dir)
        split_dir = os.path.join(parent, subs[0])
    return {split: _read_csv(os.path.join(split_dir, f"{split}.csv"))
            .astype(np.int64).reshape(-1)
            for split in ("train", "valid", "test")}


def load_ogb(root: str, name: str, min_nodes: Optional[int] = None,
             max_graphs: Optional[int] = None,
             ) -> Tuple[List[Graph], List[Graph], List[Graph]]:
    """(train, val, test) by the dataset's shipped split. `min_nodes` keeps
    graphs of at least that many nodes (6: the LSPE tier's filter);
    `max_graphs` cuts the graph table, and split indices past it are
    dropped."""
    graphs = load_ogb_graphs(root, name, max_graphs=max_graphs)
    idx = load_ogb_split_idx(root, name)
    out = []
    for split in ("train", "valid", "test"):
        sel = [graphs[i] for i in idx[split] if i < len(graphs)]
        if min_nodes is not None:
            sel = [g for g in sel if g.num_nodes >= min_nodes]
        out.append(sel)
    return tuple(out)


def find_ogb_root(datadir: str, name: str) -> Optional[str]:
    """The directory under `datadir` that holds <dataset_dir>/raw, or
    None."""
    if not datadir:
        return None
    for cand in (datadir, os.path.join(datadir, "ogb"),
                 os.path.join(datadir, "dataset")):
        if os.path.isdir(os.path.join(cand, dataset_dir_name(name), "raw")):
            return cand
    return None


def load_ogb_or_synthetic(datadir: str, name: str, synthetic_fn,
                          min_nodes: Optional[int] = None,
                          max_graphs: Optional[int] = None):
    """(train, val, test, used_real): the dataset under `datadir`, or else
    `synthetic_fn()`'s graphs split 80/10/10."""
    root = find_ogb_root(datadir, name)
    if root is not None:
        tr, va, te = load_ogb(root, name, min_nodes=min_nodes,
                              max_graphs=max_graphs)
        print(f"[data] loaded {name} from {root}: "
              f"{len(tr)}/{len(va)}/{len(te)} graphs")
        return tr, va, te, True
    print(f"[warn] no {name} raw CSVs under {datadir!r}: synthetic "
          "OGB-shaped graphs")
    graphs = synthetic_fn()
    n = len(graphs)
    return (graphs[: int(0.8 * n)], graphs[int(0.8 * n): int(0.9 * n)],
            graphs[int(0.9 * n):], False)
