"""Laplacian eigen-PE for the SAN tier (host numpy).

Per graph: the symmetric normalised Laplacian with degrees clipped at 1,
dense `eigh`, the first `max_freqs` frequencies, eigenvectors normalised to
unit length per node (over the frequency axis), eigenvalues sorted by
absolute value; both NaN-padded when the graph has fewer nodes than
`max_freqs`. The same numpy calls as the JAX package's `pe/laplace.py`, so
the results are identical.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from feta_tmlr_tpu_torch.data.batch import Graph


def laplace_decomp(graph: Graph, max_freqs: int) -> None:
    """Set `graph.eigvecs` [n, max_freqs] and `graph.eigvals` [max_freqs]."""
    n = graph.num_nodes
    a = np.zeros((n, n))
    if graph.num_edges:
        a[graph.edge_index[0], graph.edge_index[1]] = 1.0
    dis = np.clip(a.sum(1), 1.0, None) ** -0.5
    lap = np.eye(n) - dis[:, None] * a * dis[None, :]
    eigvals, eigvecs = np.linalg.eigh(lap)
    eigvals = eigvals[:max_freqs]
    eigvecs = eigvecs[:, :max_freqs]
    norms = np.linalg.norm(eigvecs, axis=1, keepdims=True)
    eigvecs = eigvecs / np.maximum(norms, 1e-12)
    vals = np.sort(np.abs(np.real(eigvals)))
    if n < max_freqs:
        eigvecs = np.pad(eigvecs, ((0, 0), (0, max_freqs - n)),
                         constant_values=np.nan)
        vals = np.pad(vals, (0, max_freqs - n), constant_values=np.nan)
    graph.eigvecs = eigvecs.astype(np.float32)
    graph.eigvals = vals.astype(np.float32)


def apply_laplace_decomp(graphs: Sequence[Graph], max_freqs: int):
    for g in graphs:
        laplace_decomp(g, max_freqs)
    return graphs
