"""Segment and COO sparse primitives, the same bits run to run.

The counterparts of the JAX package's `ops/segment.py` (`segment_sum`,
`segment_max`, `segment_mean`, `segment_softmax`, `coo_spmm`). A scatter
sum on the card (`index_add_`, `scatter_add_`, the backward of a gather
`x[idx]`) adds the rows of one segment with atomics, in an order that
changes from run to run. Here every segment reduction is a reduction over
contiguous segments of known lengths (`torch.segment_reduce`), which adds
each segment's rows in their order: ids that are not sorted are first put
in order by a stable sort, and the lengths come from `searchsorted` on the
sorted ids (no atomics, no host sync). `gather_rows` is `x[idx]` whose
backward is such a segment sum.

Segment ids lie in [0, num_segments); the reductions leave an empty
segment at 0 (sum, mean) or -inf (max), as `jax.ops.segment_*` do.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def _sorted(data: torch.Tensor, segment_ids: torch.Tensor,
            indices_are_sorted: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    ids = segment_ids.long()
    if indices_are_sorted:
        return data, ids
    ids, order = torch.sort(ids, stable=True)
    return data[order], ids


def segment_lengths(sorted_ids: torch.Tensor,
                    num_segments: int) -> torch.Tensor:
    """[num_segments] rows of each segment, from ids sorted ascending."""
    bounds = torch.arange(num_segments + 1, device=sorted_ids.device,
                          dtype=sorted_ids.dtype)
    return torch.diff(torch.searchsorted(sorted_ids, bounds))


def _reduce(data, segment_ids, num_segments, reduce, indices_are_sorted,
            **kw):
    data, ids = _sorted(data, segment_ids, indices_are_sorted)
    return torch.segment_reduce(
        data, reduce, lengths=segment_lengths(ids, num_segments), axis=0,
        unsafe=True, **kw)


def segment_sum(data, segment_ids, num_segments: int,
                indices_are_sorted: bool = False):
    """out[s] = sum of data's rows whose id is s: [num_segments, ...]."""
    return _reduce(data, segment_ids, num_segments, "sum",
                   indices_are_sorted)


def segment_max(data, segment_ids, num_segments: int,
                indices_are_sorted: bool = False):
    """out[s] = the largest of data's rows whose id is s; -inf where none."""
    return _reduce(data, segment_ids, num_segments, "max",
                   indices_are_sorted, initial=float("-inf"))


def segment_mean(data, segment_ids, num_segments: int,
                 indices_are_sorted: bool = False):
    """segment_sum over the segment's row count (empty segments: 0)."""
    data, ids = _sorted(data, segment_ids, indices_are_sorted)
    lengths = segment_lengths(ids, num_segments)
    s = torch.segment_reduce(data, "sum", lengths=lengths, axis=0,
                             unsafe=True)
    cnt = torch.clamp(lengths, min=1).to(s.dtype)
    return s / cnt.reshape(cnt.shape + (1,) * (s.ndim - 1))


class _GatherRows(torch.autograd.Function):
    """x[idx] along dim 0, whose backward sums the rows of each index with
    `segment_sum` instead of an atomic scatter."""

    @staticmethod
    def forward(ctx, x, idx):
        ctx.save_for_backward(idx)
        ctx.rows = x.shape[0]
        return x[idx]

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        flat = g.reshape((-1,) + g.shape[idx.ndim:])
        return segment_sum(flat, idx.reshape(-1), ctx.rows), None


def gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[idx] (idx of any shape, values in [0, x.shape[0])); its gradient
    is the same bits run to run."""
    return _GatherRows.apply(x, idx.long())


def segment_softmax(logits, segment_ids, num_segments: int, mask=None):
    """Softmax of per-edge logits within destination-node segments (DGL's
    edge_softmax, as the JAX twin)."""
    ids = segment_ids.long()
    if mask is not None:
        logits = torch.where(mask, logits, torch.full_like(logits, -1e30))
    seg_max = segment_max(logits, ids, num_segments)
    seg_max = torch.where(torch.isfinite(seg_max), seg_max,
                          torch.zeros_like(seg_max))
    e = torch.exp(logits - gather_rows(seg_max, ids))
    if mask is not None:
        e = torch.where(mask, e, torch.zeros_like(e))
    z = segment_sum(e, ids, num_segments)
    z = torch.where(z > 0, z, torch.ones_like(z))
    return e / gather_rows(z, ids)


def coo_spmm(edge_index, edge_weight: Optional[torch.Tensor], x,
             num_nodes: int, edge_mask=None):
    """y[dst] = sum over edges e with dst(e) = i of w_e * x[src(e)], the
    flat COO SpMM of the reference's `propagate` (flow source -> target).
    edge_index [2, E] (src, dst), edge_weight [E] or None, x [V, D],
    edge_mask [E] bool for padded edges."""
    src, dst = edge_index[0], edge_index[1]
    msg = gather_rows(x, src)
    if edge_weight is not None:
        msg = msg * edge_weight[:, None]
    if edge_mask is not None:
        msg = torch.where(edge_mask[:, None], msg, torch.zeros_like(msg))
    return segment_sum(msg, dst, num_nodes)
