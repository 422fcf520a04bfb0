"""Mask utilities for padded-dense graph batches."""

from __future__ import annotations

import torch


def pair_mask(node_mask: torch.Tensor) -> torch.Tensor:
    """[B, N] -> [B, N, N] bool of valid (query, key) node pairs."""
    m = node_mask.bool()
    return m[..., :, None] & m[..., None, :]


def pair_mask_no_diag(node_mask: torch.Tensor) -> torch.Tensor:
    """Valid node pairs without self-pairs: SAN's full graph is the complete
    graph with no self loops, so a node never attends to itself there."""
    pm = pair_mask(node_mask)
    n = pm.shape[-1]
    return pm & ~torch.eye(n, dtype=torch.bool, device=pm.device)


def in_edge_mask(adj: torch.Tensor, node_mask: torch.Tensor) -> torch.Tensor:
    """[..., i(dst), j(src)] bool: edge j -> i exists. `collate_graphs`
    writes adj[src, dst]; attention indexes [dst, src], hence the
    transpose."""
    return (adj.transpose(-1, -2) > 0) & pair_mask(node_mask)


def masked_mean(x: torch.Tensor, mask: torch.Tensor,
                dim: int) -> torch.Tensor:
    """Mean of x over `dim`, counting only entries where mask is True
    (sum over valid entries / valid count)."""
    m = mask.to(x.dtype)
    while m.ndim < x.ndim:
        m = m[..., None]
    return (x * m).sum(dim) / m.sum(dim)
