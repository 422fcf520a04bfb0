"""Mask utilities for padded-dense graph batches."""

from __future__ import annotations

import torch


def pair_mask(node_mask: torch.Tensor) -> torch.Tensor:
    """[B, N] -> [B, N, N] bool of valid (query, key) node pairs."""
    m = node_mask.bool()
    return m[..., :, None] & m[..., None, :]


def masked_mean(x: torch.Tensor, mask: torch.Tensor,
                dim: int) -> torch.Tensor:
    """Mean of x over `dim`, counting only entries where mask is True
    (sum over valid entries / valid count)."""
    m = mask.to(x.dtype)
    while m.ndim < x.ndim:
        m = m[..., None]
    return (x * m).sum(dim) / m.sum(dim)
