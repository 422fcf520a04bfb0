"""Graph containers and padded-dense batch collation.

A batch is a dataclass of dense tensors: node features padded to a bucketed
(or fixed) node count and the graph as a dense [B, N, N] adjacency, so that
attention, Laplacian builds and Chebyshev recurrences are batched matmuls.
Collation runs in numpy on the host (`node_mask == True` means a real node);
`GraphBatch.to(device)` moves the tensors to the card. With `with_coo` the
batch also carries the padded COO edge list and each node's in-edge table,
which the sparse GatedGCN / PNA layers read (`ops/sparse_agg.py`). A packed
batch (`data/pack.py`) holds several graphs a row and carries `graph_id`
(each node's graph slot in its row, -1 on padding) and `graph_mask` (the
row's valid slots).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence

import numpy as np
import torch


@dataclasses.dataclass
class Graph:
    """A single host-side graph (numpy).

    Attributes:
      x: [n, f] node features.
      edge_index: [2, e] int (source, target) pairs; undirected graphs store
        both directions.
      y: label: scalar, vector, or per-node [n].
      pe: optional [n, n] relative positional-encoding kernel.
      lap_pe: optional [n, p] absolute (Laplacian) PE.
      degree: optional [n] degree feature 1/sqrt(1+deg).
      edge_type: optional [e] int edge (bond) types, one per edge.
      eigvecs: optional [n, m] Laplacian eigenvectors, NaN-padded.
      eigvals: optional [m] eigenvalues, NaN-padded.
      edge_attr: optional [e, k] edge features (OGB bond features); only
        the COO collation carries them, as float32.
    """

    x: np.ndarray
    edge_index: np.ndarray
    y: Any = None
    pe: Optional[np.ndarray] = None
    lap_pe: Optional[np.ndarray] = None
    degree: Optional[np.ndarray] = None
    edge_type: Optional[np.ndarray] = None
    eigvecs: Optional[np.ndarray] = None
    eigvals: Optional[np.ndarray] = None
    edge_attr: Optional[np.ndarray] = None

    @property
    def num_nodes(self) -> int:
        return int(self.x.shape[0])

    @property
    def num_edges(self) -> int:
        return int(self.edge_index.shape[1])

    def compute_degree_feature(self) -> None:
        """Degree feature 1/sqrt(1+deg) over out-edges."""
        deg = np.zeros(self.num_nodes, dtype=np.float32)
        np.add.at(deg, self.edge_index[0], 1.0)
        self.degree = (1.0 / np.sqrt(1.0 + deg)).astype(np.float32)


@dataclasses.dataclass
class GraphBatch:
    """Dense batch of B graphs padded to N nodes (tensors; optional fields
    are None)."""

    x: torch.Tensor                           # [B, N, F] float or [B, N] ids
    node_mask: torch.Tensor                   # [B, N] bool, True = real node
    adj: torch.Tensor                         # [B, N, N] float
    y: Optional[torch.Tensor] = None          # [B] / [B, N] labels
    pe: Optional[torch.Tensor] = None         # [B, N, N]
    lap_pe: Optional[torch.Tensor] = None     # [B, N, P]
    degree: Optional[torch.Tensor] = None     # [B, N]
    edge_type: Optional[torch.Tensor] = None  # [B, N, N] int32 (src, dst)
    eigvecs: Optional[torch.Tensor] = None    # [B, N, M] NaN-padded
    eigvals: Optional[torch.Tensor] = None    # [B, M] NaN-padded
    edge_index: Optional[torch.Tensor] = None   # [B, 2, E] int32 COO (padded)
    edge_mask: Optional[torch.Tensor] = None    # [B, E] bool, True = real
    edge_attr: Optional[torch.Tensor] = None    # [B, E, Fe] float32
    in_edges: Optional[torch.Tensor] = None     # [B, N, K] int32 edge ids
    in_edge_mask: Optional[torch.Tensor] = None  # [B, N, K] bool
    graph_id: Optional[torch.Tensor] = None     # [B, N] int32 slot (packed)
    graph_mask: Optional[torch.Tensor] = None   # [B, G] bool valid slots

    @property
    def num_graphs(self) -> int:
        return self.x.shape[0]

    @property
    def max_nodes(self) -> int:
        return self.x.shape[1]

    def to(self, device, non_blocking: bool = False) -> "GraphBatch":
        return self._map(lambda t: t.to(device, non_blocking=non_blocking))

    def pin_memory(self) -> "GraphBatch":
        """A copy in page-locked host memory, which a card reads with
        `to(device, non_blocking=True)` without holding up the host."""
        return self._map(lambda t: t.pin_memory())

    def _map(self, fn) -> "GraphBatch":
        return GraphBatch(**{
            f.name: (None if getattr(self, f.name) is None
                     else fn(getattr(self, f.name)))
            for f in dataclasses.fields(self)})


_DEFAULT_NODE_BUCKETS = (8, 16, 24, 32, 48, 64, 96, 128, 192, 256, 384, 512)


def pad_bucket(n: int, buckets: Sequence[int] = _DEFAULT_NODE_BUCKETS) -> int:
    """Round n up to a bucket size; beyond the table, to a multiple of 128."""
    for b in buckets:
        if n <= b:
            return b
    return ((n + 127) // 128) * 128


def collate_graphs(
    graphs: Sequence[Graph],
    node_buckets: Sequence[int] = _DEFAULT_NODE_BUCKETS,
    max_nodes: Optional[int] = None,
    node_labels: Optional[bool] = None,
    with_coo: bool = False,
    edge_buckets: Optional[Sequence[int]] = None,
) -> GraphBatch:
    """Host collation into a CPU `GraphBatch`. Float features become
    float32 [B, N, F]; integer features become int32 ids, [B, N] for a
    single column (categorical atoms) and [B, N, F] otherwise.

    with_coo: also the COO view, the edges padded to a bucket of
    `edge_buckets` (default: the node buckets): `edge_index` [B, 2, E]
    (pad edges (0, 0)), `edge_mask` [B, E], `edge_attr` [B, E, Fe] where
    the graphs have edge features, and the in-edge table `in_edges` /
    `in_edge_mask` [B, N, K] (`_collate_incidence`)."""
    bsz = len(graphs)
    n_raw = max(g.num_nodes for g in graphs)
    n = max_nodes if max_nodes is not None else pad_bucket(n_raw, node_buckets)
    if n < n_raw:
        raise ValueError(f"max_nodes={n} < largest graph ({n_raw})")
    int_x = np.issubdtype(graphs[0].x.dtype, np.integer)
    squeeze_x = int_x and graphs[0].x.shape[-1] == 1
    use_pe = graphs[0].pe is not None
    use_lap = graphs[0].lap_pe is not None
    use_deg = graphs[0].degree is not None
    use_etype = graphs[0].edge_type is not None
    use_eig = graphs[0].eigvecs is not None
    for name, used in (("pe", use_pe), ("lap_pe", use_lap),
                       ("degree", use_deg)):
        if used:
            missing = [i for i, g in enumerate(graphs)
                       if getattr(g, name) is None]
            if missing:
                raise ValueError(
                    f"graph(s) {missing} lack `{name}` but graph 0 has it; "
                    "optional attributes must be consistent across a batch")

    f32 = np.float32
    if squeeze_x:
        x = np.zeros((bsz, n), dtype=np.int32)
    else:
        x = np.zeros((bsz, n, graphs[0].x.shape[-1]),
                     dtype=np.int32 if int_x else f32)
    node_mask = np.zeros((bsz, n), dtype=bool)
    adj = np.zeros((bsz, n, n), dtype=f32)
    pe = np.zeros((bsz, n, n), dtype=f32) if use_pe else None
    lap_pe = (np.zeros((bsz, n, graphs[0].lap_pe.shape[-1]), dtype=f32)
              if use_lap else None)
    degree = np.zeros((bsz, n), dtype=f32) if use_deg else None
    edge_type = np.zeros((bsz, n, n), dtype=np.int32) if use_etype else None
    eigvecs = eigvals = None
    if use_eig:
        m_freqs = graphs[0].eigvecs.shape[-1]
        eigvecs = np.full((bsz, n, m_freqs), np.nan, dtype=f32)
        eigvals = np.full((bsz, m_freqs), np.nan, dtype=f32)
    ys = []
    for i, g in enumerate(graphs):
        m = g.num_nodes
        x[i, :m] = g.x.reshape(m) if squeeze_x else g.x
        node_mask[i, :m] = True
        if g.num_edges:
            adj[i, g.edge_index[0], g.edge_index[1]] = 1.0
        if use_pe:
            pe[i, :m, :m] = g.pe
        if use_lap:
            lap_pe[i, :m, : g.lap_pe.shape[-1]] = g.lap_pe
        if use_deg:
            degree[i, :m] = g.degree
        if use_etype and g.num_edges:
            edge_type[i, g.edge_index[0], g.edge_index[1]] = \
                np.asarray(g.edge_type).ravel()
        if use_eig:
            eigvecs[i, :m] = g.eigvecs
            eigvals[i] = g.eigvals
        if g.y is not None:
            ys.append(np.asarray(g.y))
    y = _pack_labels(ys, graphs, node_labels, bsz, n)

    coo = dict.fromkeys(("edge_index", "edge_mask", "edge_attr",
                         "in_edges", "in_edge_mask"))
    if with_coo:
        coo["edge_index"], coo["edge_mask"], coo["edge_attr"] = _collate_coo(
            graphs, edge_buckets or _DEFAULT_NODE_BUCKETS)
        coo["in_edges"], coo["in_edge_mask"] = _collate_incidence(
            coo["edge_index"], coo["edge_mask"], n)

    t = lambda a: None if a is None else torch.from_numpy(a)
    return GraphBatch(x=t(x), node_mask=t(node_mask), adj=t(adj), y=t(y),
                      pe=t(pe), lap_pe=t(lap_pe), degree=t(degree),
                      edge_type=t(edge_type), eigvecs=t(eigvecs),
                      eigvals=t(eigvals),
                      **{k: t(v) for k, v in coo.items()})


def _pack_labels(ys, graphs, node_labels, bsz, n):
    if not ys:
        return None
    if node_labels is None:
        # per-node labels only when every label length equals its graph's
        # node count AND sizes vary; a uniform-size batch is ambiguous
        all_match = all(
            yy.ndim >= 1 and yy.shape[0] == g.num_nodes
            for yy, g in zip(ys, graphs))
        sizes_vary = len({g.num_nodes for g in graphs}) > 1
        if all_match and not sizes_vary and graphs[0].num_nodes > 1:
            raise ValueError(
                "ambiguous labels: every y length equals the (uniform) "
                "node count; pass node_labels=True/False explicitly")
        node_labels = all_match and sizes_vary
    if node_labels:
        yb = np.full((bsz, n) + ys[0].shape[1:], -1, dtype=ys[0].dtype)
        for i, yy in enumerate(ys):
            yb[i, : yy.shape[0]] = yy
        return yb
    return np.stack(ys)


def _collate_coo(graphs, edge_buckets):
    """(edge_index [B, 2, E] int32, edge_mask [B, E], edge_attr [B, E, Fe]
    float32 or None), E the bucket of the largest edge count (at least
    1)."""
    bsz = len(graphs)
    e = pad_bucket(max(max(g.num_edges for g in graphs), 1), edge_buckets)
    edge_index = np.zeros((bsz, 2, e), dtype=np.int32)
    edge_mask = np.zeros((bsz, e), dtype=bool)
    edge_attr = None
    if graphs[0].edge_attr is not None:
        edge_attr = np.zeros((bsz, e, graphs[0].edge_attr.shape[-1]),
                             dtype=np.float32)
    for i, g in enumerate(graphs):
        ne = g.num_edges
        edge_index[i, :, :ne] = g.edge_index
        edge_mask[i, :ne] = True
        if edge_attr is not None and ne:
            edge_attr[i, :ne] = g.edge_attr
    return edge_index, edge_mask, edge_attr


_INCIDENCE_BUCKETS = (2, 4, 8, 16, 32, 64, 128)


def _collate_incidence(edge_index, edge_mask, n):
    """The per-destination in-edge table: in_edges[b, i, k] is the id (on
    the padded E axis) of the k-th real edge, in edge order, whose
    destination is i; K is the batch's largest in-degree rounded up to a
    bucket of _INCIDENCE_BUCKETS. Segment max / min then need no
    scatter."""
    bsz = edge_index.shape[0]
    deg = np.zeros((bsz, n), dtype=np.int64)
    for i in range(bsz):
        np.add.at(deg[i], edge_index[i, 1][edge_mask[i]], 1)
    k = pad_bucket(max(int(deg.max()), 1), _INCIDENCE_BUCKETS)
    in_edges = np.zeros((bsz, n, k), dtype=np.int32)
    in_mask = np.zeros((bsz, n, k), dtype=bool)
    for i in range(bsz):
        fill = np.zeros(n, dtype=np.int64)
        for eid in np.nonzero(edge_mask[i])[0]:
            d = edge_index[i, 1, eid]
            in_edges[i, d, fill[d]] = eid
            in_mask[i, d, fill[d]] = True
            fill[d] += 1
    return in_edges, in_mask
