"""Dynamic ARMA spectral filter, dense batched.

One ARMA layer of K parallel stacks (T = 1) whose stack weights are scaled
per graph and head by the coefficient vector [a_1..a_K, b_1..b_K]:

  out = mean_k act( Anorm @ (x @ (W_init_k * a_k))
                    + x @ (W_root_k * b_k) + bias_k )

with Anorm = D^-1/2 A D^-1/2 (no self loops added). Every product goes
through `ops/cheb.py::node_matmul`, so the sums over the nodes (Anorm's
product and the weight gradients) run in the same blocks on every device.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from feta_tmlr_tpu_torch.ops.cheb import node_matmul
from feta_tmlr_tpu_torch.ops.laplacian import rsqrt_pos
from feta_tmlr_tpu_torch.ops.masking import pair_mask


def gcn_norm_no_self_loops(adj: torch.Tensor,
                           node_mask: torch.Tensor) -> torch.Tensor:
    """D^-1/2 A D^-1/2 over the masked adjacency [B, N, N], no self loops
    added (d^-1/2 = 0 where d = 0)."""
    a = adj * pair_mask(node_mask).to(adj.dtype)
    dis = rsqrt_pos(a.sum(-1))
    return dis[..., :, None] * a * dis[..., None, :]


def arma_filter_dynamic(x: torch.Tensor, anorm: torch.Tensor,
                        coeff: torch.Tensor, init_weight: torch.Tensor,
                        root_weight: torch.Tensor,
                        bias: Optional[torch.Tensor] = None,
                        activation: Optional[Callable] = torch.tanh
                        ) -> torch.Tensor:
    """x [B, H, N, D] per-head signals, anorm [B, N, N], coeff [B, H, 2K]
    (the a and b halves), init_weight and root_weight [K, D, D], bias
    [K, 1, D] -> [B, H, N, D], the mean over the K stacks."""
    k = init_weight.shape[0]
    a = coeff[..., :k, None, None]                    # [B, H, K, 1, 1]
    b = coeff[..., k:, None, None]
    xs = x[:, :, None]                                # [B, H, 1, N, D]
    xw = node_matmul(xs, init_weight * a)             # [B, H, K, N, D]
    out = (node_matmul(anorm[:, None, None], xw)
           + node_matmul(xs, root_weight * b))
    if bias is not None:
        out = out + bias
    if activation is not None:
        out = activation(out)
    return out.mean(2)
