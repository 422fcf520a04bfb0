"""Dynamic Chebyshev spectral filter, dense batched.

  Tx_0 = x ; Tx_1 = Lhat x ; Tx_k = 2 Lhat Tx_{k-1} - Tx_{k-2}
  out  = sum_k Tx_k @ W_k      with W_k per (graph, head)

Heads stay a batch axis and each order is one per-head einsum.
`cheb_filter_scalar_coeff` is the static-weight variant of the SAN layers:
W_k shared by all graphs and heads, scaled by a scalar per (graph, head).
"""

from __future__ import annotations

from typing import Optional

import torch


def cheb_filter_dynamic(x: torch.Tensor, lhat: torch.Tensor,
                        weights: torch.Tensor,
                        bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x [B, H, N, Din], lhat [B, N, N], weights [B, H, K, Din, Dout],
    bias [Dout] -> [B, H, N, Dout]."""
    k_order = weights.shape[2]
    lh = lhat[:, None]                                   # [B, 1, N, N]
    tx_prev = x
    out = torch.einsum("bhnd,bhde->bhne", tx_prev, weights[:, :, 0])
    if k_order > 1:
        tx_cur = lh @ x
        out = out + torch.einsum("bhnd,bhde->bhne", tx_cur, weights[:, :, 1])
        for k in range(2, k_order):
            tx_next = 2.0 * (lh @ tx_cur) - tx_prev
            out = out + torch.einsum("bhnd,bhde->bhne", tx_next,
                                     weights[:, :, k])
            tx_prev, tx_cur = tx_cur, tx_next
    if bias is not None:
        out = out + bias
    return out


def cheb_filter_scalar_coeff(x: torch.Tensor, lhat: torch.Tensor,
                             coeff: torch.Tensor, weight: torch.Tensor,
                             bias: Optional[torch.Tensor] = None
                             ) -> torch.Tensor:
    """out = sum_k (c_k * Tx_k) @ W_k.

    x [B, H, N, Din], lhat [B, N, N], coeff [B, H, K] scalars per graph and
    head, weight [K, Din, Dout] static, bias [Dout] -> [B, H, N, Dout]."""
    k_order = weight.shape[0]
    lh = lhat[:, None]                                   # [B, 1, N, N]
    c = coeff[..., None, None]                           # [B, H, K, 1, 1]
    tx_prev = x
    out = (tx_prev * c[:, :, 0]) @ weight[0]
    if k_order > 1:
        tx_cur = lh @ x
        out = out + (tx_cur * c[:, :, 1]) @ weight[1]
        for k in range(2, k_order):
            tx_next = 2.0 * (lh @ tx_cur) - tx_prev
            out = out + (tx_next * c[:, :, k]) @ weight[k]
            tx_prev, tx_cur = tx_cur, tx_next
    if bias is not None:
        out = out + bias
    return out
