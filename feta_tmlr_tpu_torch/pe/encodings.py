"""Host-side positional-encoding precompute (numpy/scipy).

PEs are per-graph constants computed once on the host and carried in the
batch. Numerical quirks kept on purpose, as in the JAX package:
  - LapEncoding eigendecomposes the Laplacian with np.linalg.eig (not eigh)
    and takes the real part, with the reference's zero-pad rule for graphs
    with fewer than dim+1 nodes;
  - DiffusionEncoding is expm(-beta * L), the JAX package's kernel; the
    port takes it with the dense scipy.linalg.expm, as the result is dense
    anyway: the sparse expm's products fill in and take minutes a graph at
    N=2048, against seconds (the float32 PEs agree bit for bit on the
    tests' graphs).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import scipy.linalg
import scipy.sparse as sp

from feta_tmlr_tpu_torch.data.batch import Graph


def graph_laplacian(
    edge_index: np.ndarray,
    num_nodes: int,
    normalization: Optional[str] = None,
) -> sp.csc_matrix:
    """Sparse graph Laplacian with PyG `get_laplacian` semantics.

    None: L = D - A; 'sym': I - D^-1/2 A D^-1/2 (d^-1/2 = 0 where d = 0,
    diagonal 1 for every node); 'rw': I - D^-1 A. Self loops are dropped.
    """
    row, col = edge_index[0], edge_index[1]
    keep = row != col
    row, col = row[keep], col[keep]
    a = sp.coo_matrix((np.ones(row.shape[0]), (row, col)),
                      shape=(num_nodes, num_nodes))
    deg = np.asarray(a.sum(axis=1)).ravel()
    if normalization is None:
        lap = sp.diags(deg) - a
    elif normalization == "sym":
        dis = np.zeros_like(deg)
        nz = deg > 0
        dis[nz] = deg[nz] ** -0.5
        lap = sp.eye(num_nodes) - sp.diags(dis) @ a @ sp.diags(dis)
    elif normalization == "rw":
        dinv = np.zeros_like(deg)
        nz = deg > 0
        dinv[nz] = 1.0 / deg[nz]
        lap = sp.eye(num_nodes) - sp.diags(dinv) @ a
    else:
        raise ValueError(f"invalid normalization {normalization!r}")
    return lap.tocsc()


class DiffusionEncoding:
    """Relative PE kernel expm(-beta * L), stored as float32 `graph.pe`."""

    def __init__(self, beta: float = 1.0,
                 normalization: Optional[str] = None):
        self.beta = beta
        self.normalization = normalization

    def compute_pe(self, graph: Graph) -> np.ndarray:
        lap = graph_laplacian(graph.edge_index, graph.num_nodes,
                              self.normalization)
        return scipy.linalg.expm(-self.beta * lap.toarray())

    def apply_to(self, graphs: Sequence[Graph]) -> Sequence[Graph]:
        for g in graphs:
            g.pe = self.compute_pe(g).astype(np.float32)
        return graphs


class LapEncoding:
    """Absolute PE: Laplacian eigenvectors 1..dim (ascending eigenvalue),
    zero-padded to `dim` columns, stored as float32 `graph.lap_pe`."""

    def __init__(self, dim: int, normalization: Optional[str] = None):
        self.pos_enc_dim = dim
        self.normalization = normalization

    def compute_pe(self, graph: Graph) -> np.ndarray:
        lap = graph_laplacian(graph.edge_index, graph.num_nodes,
                              self.normalization)
        eigval, eigvec = np.linalg.eig(lap.toarray())
        idx = eigval.argsort()
        eigvec = np.real(eigvec[:, idx])
        vec = eigvec[:, 1: self.pos_enc_dim + 1]
        if vec.shape[1] < self.pos_enc_dim:
            pad = np.zeros((vec.shape[0], self.pos_enc_dim))
            pad[:, : vec.shape[1]] = vec
            vec = pad
        return vec.astype(np.float32)

    def apply_to(self, graphs: Sequence[Graph]) -> Sequence[Graph]:
        for g in graphs:
            g.lap_pe = self.compute_pe(g)
        return graphs
