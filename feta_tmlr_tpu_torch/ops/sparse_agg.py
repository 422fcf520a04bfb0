"""Aggregation over the real edges of a padded COO batch, as one-hot
products.

The GatedGCN and PNA layers aggregate messages over real in-edges only.
Their sparse mode reads `GraphBatch.edge_index [B, 2, E]` / `edge_mask
[B, E]` (`collate_graphs(with_coo=True)`) instead of the dense
[B, N, N, D] mailbox. Every gather (node -> edge) and every segment sum
(edge -> destination node) is a product with a one-hot [B, E, N] matrix,
and segment max / min read each node's in-edges through the one-hot of
the in-edge table [B, N, K, E], as the JAX package's `ops/sparse_agg.py`
computes them.

The one-hot product is deterministic: a segment sum by `index_add_` or
`scatter_reduce` runs on atomics on CUDA, whose order of summation, and so
whose float32 rounding, changes from run to run. The products keep a
training run bit-exact on resume and the card's sums in a fixed order.

On real entries the results equal the dense masked forms: a one-hot row
selects one value, and pad edges have zero rows, which every consumer
masks.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


class SparseEdges:
    """The per-step COO context that every sparse layer shares: the
    masked one-hot source and destination matrices [B, E, N], the in-edge
    incidence one-hot [B, N, K, E] (or None) with its mask [B, N, K], and
    each node's in-degree [B, N]."""

    def __init__(self, src, dst, edge_mask, oh_src, oh_dst, inc_oh=None,
                 in_edge_mask=None):
        self.src, self.dst, self.edge_mask = src, dst, edge_mask
        self.oh_src, self.oh_dst = oh_src, oh_dst
        self.inc_oh, self.in_edge_mask = inc_oh, in_edge_mask
        self.deg = oh_dst.sum(1)                              # [B, N]

    def gather_src(self, x: torch.Tensor) -> torch.Tensor:
        """x [..., B, N, D] -> x[src] per edge [..., B, E, D], zero on pad
        edges."""
        return self.oh_src @ x.to(self.oh_src.dtype)

    def gather_dst(self, x: torch.Tensor) -> torch.Tensor:
        return self.oh_dst @ x.to(self.oh_dst.dtype)

    def segment_sum(self, msg: torch.Tensor) -> torch.Tensor:
        """Per-destination sum of edge messages [..., B, E, F] -> [..., B,
        N, F]; pad edges add zero rows."""
        return self.oh_dst.transpose(1, 2) @ msg


def make_sparse_edges(batch, dtype=torch.float32,
                      with_incidence: bool = False) -> SparseEdges:
    """SparseEdges of a batch collated with `with_coo=True`."""
    src = batch.edge_index[:, 0].long()
    dst = batch.edge_index[:, 1].long()
    n = batch.max_nodes
    emf = batch.edge_mask.to(dtype)[..., None]
    oh_src = F.one_hot(src, n).to(dtype) * emf
    oh_dst = F.one_hot(dst, n).to(dtype) * emf
    inc_oh = in_mask = None
    if with_incidence:
        if batch.in_edges is None:
            raise ValueError("batch lacks in_edges (collate with_coo=True "
                             "builds them)")
        inc_oh = (F.one_hot(batch.in_edges.long(), src.shape[-1]).to(dtype)
                  * batch.in_edge_mask.to(dtype)[..., None])
        in_mask = batch.in_edge_mask
    return SparseEdges(src, dst, batch.edge_mask, oh_src, oh_dst, inc_oh,
                       in_mask)


def incidence_values(msg: torch.Tensor, edges: SparseEdges) -> torch.Tensor:
    """msg [..., B, E, F] -> each node's in-edge values [..., B, N, K, F]
    by the incidence one-hot (masked slots are zero)."""
    b, n, k, e = edges.inc_oh.shape
    out = edges.inc_oh.reshape(b, n * k, e) @ msg.to(edges.inc_oh.dtype)
    return out.reshape(out.shape[:-2] + (n, k, out.shape[-1]))


def _incidence_reduce(msg, edges, fill, reduce):
    g = incidence_values(msg, edges)
    g = torch.where(edges.in_edge_mask[..., None], g,
                    torch.full_like(g, fill))
    out = reduce(g)
    return torch.where(edges.deg[..., None] > 0, out, torch.zeros_like(out))


def incidence_max(msg: torch.Tensor, edges: SparseEdges) -> torch.Tensor:
    """Per-destination max over real in-edges; 0 for a node without one
    (DGL's update_all fills empty mailboxes with zeros)."""
    return _incidence_reduce(msg, edges, float("-inf"),
                             lambda g: g.amax(-2))


def incidence_min(msg: torch.Tensor, edges: SparseEdges) -> torch.Tensor:
    return _incidence_reduce(msg, edges, float("inf"), lambda g: g.amin(-2))


def edge_ids_from_dense(dense_field: torch.Tensor, src: torch.Tensor,
                        dst: torch.Tensor) -> torch.Tensor:
    """Per-edge values [B, E] of a dense [B, N, N] field at the (src, dst)
    pairs (integer ids: no gradient flows through this gather)."""
    b, n, _ = dense_field.shape
    return torch.gather(dense_field.reshape(b, n * n), 1,
                        (src * n + dst).long())


def edge_gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [B, N, D], idx [B, E] -> x[b, idx[b, e]] [B, E, D] (a plain
    gather; the layers take `SparseEdges.gather_src` / `gather_dst`)."""
    return torch.gather(x, 1, idx.long()[..., None].expand(
        *idx.shape, x.shape[-1]))


def dst_onehot(dst: torch.Tensor, edge_mask: torch.Tensor, n: int,
               dtype=torch.float32) -> torch.Tensor:
    """[B, E, N] one-hot of each edge's destination, zero on pad edges."""
    return F.one_hot(dst.long(), n).to(dtype) * edge_mask.to(dtype)[..., None]


def edge_segment_sum(msg: torch.Tensor, oh: torch.Tensor) -> torch.Tensor:
    """Per-destination sum of edge messages [B, E, F] with the one-hot
    [B, E, N] -> [B, N, F]."""
    return oh.transpose(1, 2) @ msg

