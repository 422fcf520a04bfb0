"""Random-walk positional encoding of the LSPE tier.

`rwpe(graph, dim)` stacks the k-step random-walk landing probabilities
diag((D^-1 A)^k), k = 1..dim, per node (the reference's
`init_positional_encoding` with `rand_walk`): the LSPE nets' initial
positional channel p. Host-side numpy / scipy, as the JAX package's
`pe/rwpe.py`, whose float32 output it equals exactly.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import scipy.sparse as sp

from feta_tmlr_tpu_torch.data.batch import Graph


def rwpe(graph: Graph, dim: int) -> np.ndarray:
    """[n, dim] float32: column k-1 is diag((D^-1 A)^k); a node with no
    out-edge has a zero row of D^-1 A."""
    n = graph.num_nodes
    row, col = graph.edge_index[0], graph.edge_index[1]
    a = sp.coo_matrix((np.ones(len(row)), (row, col)), shape=(n, n)).tocsr()
    deg = np.asarray(a.sum(axis=1)).ravel()
    dinv = np.zeros_like(deg)
    dinv[deg > 0] = 1.0 / deg[deg > 0]
    rw = sp.diags(dinv) @ a
    out = np.zeros((n, dim), dtype=np.float32)
    m = rw
    out[:, 0] = m.diagonal()
    for k in range(1, dim):
        m = m @ rw
        out[:, k] = m.diagonal()
    return out


def apply_rwpe(graphs: Sequence[Graph], dim: int) -> Sequence[Graph]:
    """Store `rwpe(g, dim)` as every graph's `lap_pe` (the p channel's
    input, which the LSPE nets read from `batch.lap_pe`)."""
    for g in graphs:
        g.lap_pe = rwpe(g, dim)
    return graphs
