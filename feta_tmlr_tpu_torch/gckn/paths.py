"""Host-side path batches for GCKN.

The counterpart of the JAX package's `gckn/paths.py` (the reference's
`PathLoader.get_all_paths` / `make_batch`): a list of graphs becomes one
flat node set, each graph's enumerated paths are offset into the flat
numbering, and each path size keeps per-node path counts for the segment
pooling. Path rows are padded to `pad_bucket` sizes: a padded row points
at the dummy node slot V (zero features) and pools into the dummy segment
V. Within a path size the segment ids are sorted (each node's paths are
contiguous, in node order, padding last), which the pooling relies on
(`gckn/ops.py`).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence

import numpy as np

from feta_tmlr_tpu_torch.data.batch import Graph, pad_bucket
from feta_tmlr_tpu_torch.gckn.pathenum import enumerate_paths


@dataclasses.dataclass
class PathBatch:
    """Flat multi-graph path batch (numpy, host)."""

    features: np.ndarray          # [V+1, F] node features (+ zero dummy row)
    n_nodes: int                  # V (without dummy)
    node2graph: np.ndarray        # [V+1] graph id (dummy -> n_graphs)
    n_graphs: int
    # per path size s (1..k):
    path_indices: List[np.ndarray]   # [P_s, s] int32 into features rows
    path_mask: List[np.ndarray]      # [P_s] bool
    segment_ids: List[np.ndarray]    # [P_s] int32 node id per path (dummy V)
    counts: List[np.ndarray]         # [V] paths per node
    graph_n_nodes: np.ndarray        # [n_graphs]
    # the batch's arrays on a device and its block plans, made once
    # (`gckn/layer.py::device_paths`)
    cache: Dict = dataclasses.field(default_factory=dict, repr=False,
                                    compare=False)


def build_path_batch(graphs: Sequence[Graph], k: int, pad: bool = True,
                     impl: str = "native") -> PathBatch:
    """The paths of 1..k nodes of every graph, enumerated by `impl`
    (`gckn/pathenum.py`)."""
    feats, p_idx, seg, counts_all = [], [[] for _ in range(k)], \
        [[] for _ in range(k)], [[] for _ in range(k)]
    node_offset = 0
    node2graph = []
    for gi, g in enumerate(graphs):
        n = g.num_nodes
        feats.append(np.asarray(g.x, dtype=np.float32))
        node2graph.append(np.full(n, gi, dtype=np.int32))
        paths, counts = enumerate_paths(g.edge_index, n, k, impl=impl)
        for s in range(k):
            p_idx[s].append(paths[s] + node_offset)
            seg[s].append(
                np.repeat(np.arange(n, dtype=np.int64) + node_offset,
                          counts[s]))
            counts_all[s].append(counts[s])
        node_offset += n

    v = node_offset
    features = np.concatenate(feats + [np.zeros((1, feats[0].shape[-1]),
                                                np.float32)])
    node2graph = np.concatenate(
        node2graph + [np.asarray([len(graphs)], np.int32)])

    path_indices, path_mask, segment_ids, counts = [], [], [], []
    for s in range(k):
        pi = np.concatenate(p_idx[s]).astype(np.int32).reshape(-1, s + 1)
        si = np.concatenate(seg[s]).astype(np.int32)
        n_real = pi.shape[0]
        n_pad = pad_bucket(max(n_real, 1)) if pad else n_real
        pi_pad = np.full((n_pad, s + 1), v, dtype=np.int32)
        si_pad = np.full((n_pad,), v, dtype=np.int32)
        mask = np.zeros(n_pad, dtype=bool)
        pi_pad[:n_real] = pi
        si_pad[:n_real] = si
        mask[:n_real] = True
        path_indices.append(pi_pad)
        path_mask.append(mask)
        segment_ids.append(si_pad)
        counts.append(np.concatenate(counts_all[s]).astype(np.int64))

    return PathBatch(
        features=features, n_nodes=v, node2graph=node2graph,
        n_graphs=len(graphs), path_indices=path_indices,
        path_mask=path_mask, segment_ids=segment_ids, counts=counts,
        graph_n_nodes=np.asarray([g.num_nodes for g in graphs]))
