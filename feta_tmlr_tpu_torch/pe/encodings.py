"""Host-side positional-encoding precompute (numpy/scipy).

PEs are per-graph constants computed once on the host and carried in the
batch; the relative kernels (`POSENCODINGS`: diffusion, p-step random
walk, adjacency) can be cached to disk per split (`pe/cache.py`).
Numerical quirks kept on purpose, as in the JAX package:
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

from typing import List, Optional, Sequence

import numpy as np
import scipy.linalg
import scipy.sparse as sp

from feta_tmlr_tpu_torch.data.batch import Graph
from feta_tmlr_tpu_torch.pe.cache import PECache


def graph_laplacian(
    edge_index: np.ndarray,
    num_nodes: int,
    normalization: Optional[str] = None,
    edge_weight: Optional[np.ndarray] = None,
) -> sp.csc_matrix:
    """Sparse graph Laplacian with PyG `get_laplacian` semantics.

    None: L = D - A; 'sym': I - D^-1/2 A D^-1/2 (d^-1/2 = 0 where d = 0,
    diagonal 1 for every node); 'rw': I - D^-1 A. Self loops are dropped;
    edges weigh 1 unless `edge_weight` gives one per edge.
    """
    if edge_weight is None:
        edge_weight = np.ones(edge_index.shape[1], dtype=np.float64)
    row, col = edge_index[0], edge_index[1]
    keep = row != col
    row, col, w = row[keep], col[keep], edge_weight[keep]
    a = sp.coo_matrix((w, (row, col)), shape=(num_nodes, num_nodes))
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


def _laplacian_of(graph: Graph, normalization: Optional[str],
                  use_edge_attr: bool) -> sp.csc_matrix:
    ew = None
    if use_edge_attr and graph.edge_attr is not None:
        ew = np.asarray(graph.edge_attr).ravel()
    return graph_laplacian(graph.edge_index, graph.num_nodes, normalization,
                           ew)


class PositionEncoding:
    """Base of the relative PE kernels: per-graph `compute_pe`, an
    optional disk cache keyed by `cache_key()` and split, and `zero_diag`
    (the kernel's diagonal set to 0). `apply_to` stores float32
    `graph.pe` [n, n]."""

    def __init__(self, cache: Optional[PECache] = None,
                 zero_diag: bool = False):
        self.cache = cache
        self.zero_diag = zero_diag

    def compute_pe(self, graph: Graph) -> np.ndarray:
        raise NotImplementedError

    def cache_key(self) -> str:
        return type(self).__name__

    def apply_to(self, graphs: Sequence[Graph], split: str = "all"
                 ) -> Sequence[Graph]:
        cached = (self.cache.load(self.cache_key(), split)
                  if self.cache else None)
        computed: List[np.ndarray] = []
        for i, g in enumerate(graphs):
            pe = cached[i] if cached is not None else self.compute_pe(g)
            if cached is None:
                computed.append(pe)
            if self.zero_diag:
                pe = pe.copy()
                np.fill_diagonal(pe, 0)
            g.pe = pe.astype(np.float32)
        if self.cache and cached is None:
            self.cache.save(self.cache_key(), split, computed)
        return graphs


class DiffusionEncoding(PositionEncoding):
    """Relative PE kernel expm(-beta * L)."""

    def __init__(self, beta: float = 1.0,
                 normalization: Optional[str] = None,
                 use_edge_attr: bool = False, cache=None, zero_diag=False):
        super().__init__(cache, zero_diag)
        self.beta = beta
        self.normalization = normalization
        self.use_edge_attr = use_edge_attr

    def cache_key(self) -> str:
        return (f"diffusion_{self.beta}_{self.normalization}"
                f"_{self.use_edge_attr}")

    def compute_pe(self, graph: Graph) -> np.ndarray:
        lap = _laplacian_of(graph, self.normalization, self.use_edge_attr)
        return scipy.linalg.expm(-self.beta * lap.toarray())


class PStepRWEncoding(PositionEncoding):
    """Relative PE kernel (I - beta * L)^p, by sparse products."""

    def __init__(self, p: int = 1, beta: float = 0.5,
                 normalization: Optional[str] = None,
                 use_edge_attr: bool = False, cache=None, zero_diag=False):
        super().__init__(cache, zero_diag)
        self.p = p
        self.beta = beta
        self.normalization = normalization
        self.use_edge_attr = use_edge_attr

    def cache_key(self) -> str:
        return (f"pstep_{self.p}_{self.beta}_{self.normalization}"
                f"_{self.use_edge_attr}")

    def compute_pe(self, graph: Graph) -> np.ndarray:
        lap = _laplacian_of(graph, self.normalization, self.use_edge_attr)
        base = sp.identity(lap.shape[0], dtype=lap.dtype) - self.beta * lap
        out = base
        for _ in range(self.p - 1):
            out = out.dot(base)
        return np.asarray(out.todense())


class AdjEncoding(PositionEncoding):
    """The dense adjacency as the PE kernel (`normalization` is kept for
    the reference's signature and not applied, as there)."""

    def __init__(self, normalization: Optional[str] = None, cache=None,
                 zero_diag=False):
        super().__init__(cache, zero_diag)
        self.normalization = normalization

    def compute_pe(self, graph: Graph) -> np.ndarray:
        n = graph.num_nodes
        a = np.zeros((n, n))
        a[graph.edge_index[0], graph.edge_index[1]] = 1.0
        return a


class FullEncoding(PositionEncoding):
    """The all-ones kernel."""

    def compute_pe(self, graph: Graph) -> np.ndarray:
        n = graph.num_nodes
        return np.ones((n, n))


class LapEncoding:
    """Absolute PE: Laplacian eigenvectors 1..dim (ascending eigenvalue),
    zero-padded to `dim` columns, stored as float32 `graph.lap_pe`."""

    def __init__(self, dim: int, normalization: Optional[str] = None,
                 use_edge_attr: bool = False):
        self.pos_enc_dim = dim
        self.normalization = normalization
        self.use_edge_attr = use_edge_attr

    def compute_pe(self, graph: Graph) -> np.ndarray:
        lap = _laplacian_of(graph, self.normalization, self.use_edge_attr)
        eigval, eigvec = np.linalg.eig(lap.toarray())
        idx = eigval.argsort()
        eigvec = np.real(eigvec[:, idx])
        vec = eigvec[:, 1: self.pos_enc_dim + 1]
        if vec.shape[1] < self.pos_enc_dim:
            pad = np.zeros((vec.shape[0], self.pos_enc_dim))
            pad[:, : vec.shape[1]] = vec
            vec = pad
        return vec.astype(np.float32)

    def apply_to(self, graphs: Sequence[Graph], split: str = "all"
                 ) -> Sequence[Graph]:
        for g in graphs:
            g.lap_pe = self.compute_pe(g)
        return graphs


POSENCODINGS = {
    "diffusion": DiffusionEncoding,
    "pstep": PStepRWEncoding,
    "adj": AdjEncoding,
}
