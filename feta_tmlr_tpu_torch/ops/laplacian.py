"""Dense batched graph Laplacians and GCN normalizations.

`cheb_scaled_laplacian` builds Lhat = 2 L / lambda_max - I as one dense
[B, N, N] matrix (self loops removed first; PyG get_laplacian diagonal of 1
on every real node under 'sym'); `graph_laplacian_dense` the unscaled L of
the same normalizations; `gcn_norm_dense` the symmetric GCN normalization
(with the missing self loops filled) and `gcn_norm_directed` its directed
form over the attention graph. Padded rows and columns are zero.
"""

from __future__ import annotations

from typing import Optional

import torch

from feta_tmlr_tpu_torch.ops.masking import pair_mask


def rsqrt_pos(x: torch.Tensor) -> torch.Tensor:
    """x^-1/2 where x > 0, else 0."""
    return torch.where(x > 0, torch.where(x > 0, x, torch.ones_like(x))
                       .rsqrt(), torch.zeros_like(x))


def cheb_scaled_laplacian(adj: torch.Tensor, node_mask: torch.Tensor,
                          normalization: Optional[str] = "sym",
                          lambda_max=None) -> torch.Tensor:
    """Scaled Chebyshev Laplacian, dense batched.

    lambda_max defaults to 2 under 'sym' only; 'rw' and None need an
    explicit scalar or [B] bound (their spectrum is not bounded by 2).
    """
    if lambda_max is None:
        if normalization != "sym":
            raise ValueError(
                "lambda_max is required for non-'sym' normalization")
        lambda_max = 2.0
    mask = node_mask.to(adj.dtype)
    pm = pair_mask(node_mask).to(adj.dtype)
    n = adj.shape[-1]
    eye = torch.eye(n, dtype=adj.dtype, device=adj.device)
    a = adj * pm * (1.0 - eye)
    deg = a.sum(-1)
    if normalization == "sym":
        dis = rsqrt_pos(deg)
        off = -dis[..., :, None] * a * dis[..., None, :]
        diag = mask
    elif normalization == "rw":
        off = -torch.where(deg > 0, 1.0 / torch.where(
            deg > 0, deg, torch.ones_like(deg)), torch.zeros_like(deg)
        )[..., :, None] * a
        diag = mask
    elif normalization is None:
        off = -a
        diag = deg
    else:
        raise ValueError(f"invalid normalization {normalization!r}")
    if isinstance(lambda_max, (int, float)):    # no copy to the device
        scale = 2.0 / lambda_max if lambda_max else 0.0
    else:
        lam = torch.as_tensor(lambda_max, dtype=adj.dtype, device=adj.device)
        scale = 2.0 / lam
        scale = torch.where(torch.isinf(scale), torch.zeros_like(scale),
                            scale)
        if scale.ndim == 1:
            scale = scale[:, None, None]
    lhat = scale * (off + diag[..., :, None] * eye) - mask[..., :, None] * eye
    return lhat * pm


def gcn_norm_dense(adj: torch.Tensor, node_mask: torch.Tensor,
                   add_self_loops: bool = True) -> torch.Tensor:
    """D^-1/2 A D^-1/2 of a symmetric weighted adjacency: with
    `add_self_loops`, each real node's missing self loop filled with 1 (an
    existing one keeps its weight), degrees the row sums (d^-1/2 = 0 where
    d = 0)."""
    a = adj * pair_mask(node_mask).to(adj.dtype)
    if add_self_loops:
        n = a.shape[-1]
        eye = torch.eye(n, dtype=a.dtype, device=a.device)
        diag = torch.diagonal(a, dim1=-2, dim2=-1)
        missing = (diag == 0) & node_mask.bool()
        a = a + missing.to(a.dtype)[..., :, None] * eye
    dis = rsqrt_pos(a.sum(-1))
    return dis[..., :, None] * a * dis[..., None, :]


def graph_laplacian_dense(adj: torch.Tensor, node_mask: torch.Tensor,
                          normalization: Optional[str] = "sym"
                          ) -> torch.Tensor:
    """Unscaled Laplacian, self loops removed first: None D - A, 'sym'
    I - D^-1/2 A D^-1/2, 'rw' I - D^-1 A (the identity on real nodes
    only)."""
    pm = pair_mask(node_mask).to(adj.dtype)
    n = adj.shape[-1]
    eye = torch.eye(n, dtype=adj.dtype, device=adj.device)
    a = adj * pm * (1.0 - eye)
    deg = a.sum(-1)
    mask = node_mask.to(adj.dtype)
    if normalization == "sym":
        dis = rsqrt_pos(deg)
        lap = -dis[..., :, None] * a * dis[..., None, :] \
            + mask[..., :, None] * eye
    elif normalization == "rw":
        dinv = torch.where(deg > 0, 1.0 / torch.where(
            deg > 0, deg, torch.ones_like(deg)), torch.zeros_like(deg))
        lap = -dinv[..., :, None] * a + mask[..., :, None] * eye
    else:
        lap = -a + deg[..., :, None] * eye
    return lap * pm


def gcn_norm_directed(a: torch.Tensor, node_mask: torch.Tensor,
                      fill: float = 1.0) -> torch.Tensor:
    """PyG gcn_norm over a directed weighted graph a[..., i(src), j(dst)]:
    missing self loops of real nodes filled with `fill` (existing ones
    kept), in-degree deg[j] = sum_i a[i, j], and
    norm(i -> j) = deg^-1/2[i] a[i, j] deg^-1/2[j]."""
    a = a * pair_mask(node_mask).to(a.dtype)
    n = a.shape[-1]
    eye = torch.eye(n, dtype=a.dtype, device=a.device)
    diag = torch.diagonal(a, dim1=-2, dim2=-1)
    missing = (diag == 0) & node_mask.bool()
    a = a + fill * missing.to(a.dtype)[..., :, None] * eye
    dis = rsqrt_pos(a.sum(-2))
    return dis[..., :, None] * a * dis[..., None, :]
