"""The largest eigenvalue of each graph's Laplacian, for the Chebyshev
filter's scaling under a normalization other than 'sym' (whose spectrum is
not bounded by 2).

A batched power iteration over the dense [B, N, N] Laplacian: a fixed
number of matrix-vector products from the same start on every device, with
no data-dependent stop, so it never waits on the host.
"""

from __future__ import annotations

from typing import Optional

import torch

from feta_tmlr_tpu_torch.ops.laplacian import graph_laplacian_dense


def _unit(v: torch.Tensor, eps: float) -> torch.Tensor:
    return v / torch.linalg.vector_norm(v, dim=-1, keepdim=True).clamp_min(
        eps)


def power_iteration_lambda_max(mat: torch.Tensor, node_mask: torch.Tensor,
                               n_iters: int = 50,
                               eps: float = 1e-12) -> torch.Tensor:
    """|lambda|max [B] of each symmetric mat [B, N, N]: `n_iters` power
    steps from the real nodes' profile 1 + sin(1.7 i) (the ones vector is
    the null vector of D - A), then the Rayleigh quotient."""
    n = mat.shape[-1]
    profile = 1.0 + torch.sin(
        torch.arange(n, dtype=mat.dtype, device=mat.device) * 1.7)
    v = _unit(node_mask.to(mat.dtype) * profile, eps)
    for _ in range(n_iters):
        v = _unit((mat @ v[..., None])[..., 0], eps)
    w = (mat @ v[..., None])[..., 0]
    return (v * w).sum(-1).abs() / (v * v).sum(-1).clamp_min(eps)


def laplacian_lambda_max(adj: torch.Tensor, node_mask: torch.Tensor,
                         normalization: Optional[str] = None,
                         n_iters: int = 50) -> torch.Tensor:
    """lambda_max [B] of the graph Laplacian under `normalization`."""
    lap = graph_laplacian_dense(adj, node_mask, normalization)
    return power_iteration_lambda_max(lap, node_mask, n_iters)
