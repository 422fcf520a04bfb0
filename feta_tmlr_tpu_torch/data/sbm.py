"""GNNBenchmark SBM (PATTERN/CLUSTER) loader for the reference's on-disk
format: ``<data_dir>/<NAME>_<split>.pkl``, a pickled list of records each
carrying

  ``node_feat``   [N] int tensor of input ids
  ``W``           [N, N] adjacency (0/1) tensor
  ``node_label``  [N] int tensor of per-node classes

The benchmarking-gnns generator pickles these as ``DotDict`` instances whose
class lives in the generating notebook's ``__main__`` (or other module paths
across forks); a tolerant unpickler maps any class named ``DotDict`` onto a
local attr-dict, so the files load without that module. Torch tensors inside
load natively. The same reading rules as the JAX package's `data/sbm.py`.
"""

from __future__ import annotations

import io
import os
import pickle
from typing import List, Optional, Tuple

import numpy as np

import torch

from feta_tmlr_tpu_torch.data.batch import Graph


class DotDict(dict):
    """benchmarking-gnns' pickled record type: a dict with attr access."""

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError as e:  # pragma: no cover - mirrors dict.get(None)
            raise AttributeError(name) from e

    def __setattr__(self, name, value):
        self[name] = value


class _TolerantUnpickler(pickle.Unpickler):
    """Resolve any class named DotDict to the local shim; everything else
    (torch tensor reconstruction, numpy) resolves normally."""

    def find_class(self, module, name):
        if name == "DotDict":
            return DotDict
        return super().find_class(module, name)


def _to_numpy(x) -> np.ndarray:
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _get(rec, key):
    if isinstance(rec, dict):
        return rec[key]
    return getattr(rec, key)


def record_to_graph(rec) -> Graph:
    """One SBM record -> host Graph.

    Mirrors load_SBMsDataSetDGL._prepare (LPE/data/SBMs.py:33-55): edges are
    the nonzeros of W (W is symmetric with both directions stored); edge
    features are constant 1 (edge_feat_dim=1, SBMs.py:50-52), carried here
    as edge_type=1 for the embedding-based tiers.
    """
    node_feat = _to_numpy(_get(rec, "node_feat")).astype(np.int32).reshape(-1)
    W = _to_numpy(_get(rec, "W"))
    label = _to_numpy(_get(rec, "node_label")).astype(np.int32).reshape(-1)
    n = node_feat.shape[0]
    if W.shape != (n, n) or label.shape[0] != n:
        raise ValueError(f"inconsistent SBM record: node_feat {n}, "
                         f"W {W.shape}, node_label {label.shape}")
    rows, cols = np.nonzero(W)
    edge_index = np.stack([rows, cols]).astype(np.int32)
    g = Graph(x=node_feat[:, None], edge_index=edge_index, y=label,
              edge_type=np.ones(edge_index.shape[1], np.int32))
    g.compute_degree_feature()
    return g


def load_sbm_split(data_dir: str, name: str, split: str) -> List[Graph]:
    """Load ``<data_dir>/<name>_<split>.pkl`` (LPE/data/SBMs.py:26-27)."""
    path = os.path.join(data_dir, f"{name}_{split}.pkl")
    with open(path, "rb") as f:
        records = _TolerantUnpickler(io.BufferedReader(f)).load()
    return [record_to_graph(r) for r in records]


def load_sbm(data_dir: str, name: str,
             max_graphs_per_split: Optional[int] = None,
             ) -> Tuple[List[Graph], List[Graph], List[Graph]]:
    """(train, val, test) for SBM_PATTERN / SBM_CLUSTER
    (SBMsDatasetDGL, LPE/data/SBMs.py:80-95)."""
    out = []
    for split in ("train", "val", "test"):
        graphs = load_sbm_split(data_dir, name, split)
        if max_graphs_per_split is not None:
            graphs = graphs[:max_graphs_per_split]
        out.append(graphs)
    return tuple(out)


def find_sbm_dir(datadir: str, name: str) -> Optional[str]:
    """Resolve the SBMs directory (reference keeps them at ``data/SBMs``,
    LPE/data/SBMs.py:88)."""
    if not datadir:
        return None
    for cand in (datadir, os.path.join(datadir, "SBMs")):
        if os.path.exists(os.path.join(cand, f"{name}_train.pkl")):
            return cand
    return None


def num_classes(graphs: List[Graph]) -> int:
    return int(max(int(g.y.max()) for g in graphs)) + 1


def load_sbm_or_synthetic(datadir: str, name: str = "SBM_PATTERN",
                          seed: int = 0, n_synthetic: int = 48,
                          n_nodes: int = 64, n_classes: int = 2,
                          max_graphs_per_split: Optional[int] = None):
    """(train, val, test, used_real)."""
    real = find_sbm_dir(datadir, name)
    if real is not None:
        tr, va, te = load_sbm(real, name,
                              max_graphs_per_split=max_graphs_per_split)
        print(f"[data] loaded {name} from {real}: "
              f"{len(tr)}/{len(va)}/{len(te)} graphs")
        return tr, va, te, True
    from feta_tmlr_tpu_torch.data.synthetic import sbm_like_dataset
    print(f"[warn] no {name} pickles under {datadir!r} - synthetic SBM "
          f"fallback ({n_synthetic} graphs)")
    graphs = sbm_like_dataset(seed=seed, n_graphs=n_synthetic,
                              n_nodes=n_nodes, n_classes=n_classes)
    for g in graphs:
        g.x = np.argmax(g.x, -1).astype(np.int32)[:, None]
        g.edge_type = np.ones(g.num_edges, np.int32)
    n = len(graphs)
    return (graphs[: int(0.8 * n)],
            graphs[int(0.8 * n): int(0.9 * n)],
            graphs[int(0.9 * n):], False)
