"""Dynamic Chebyshev spectral filter, dense batched.

  Tx_0 = x ; Tx_1 = Lhat x ; Tx_k = 2 Lhat Tx_{k-1} - Tx_{k-2}
  out  = sum_k Tx_k @ W_k      with W_k per (graph, head)

Heads stay a batch axis and each order is one per-head product.
`cheb_filter_scalar_coeff` is the static-weight variant of the SAN layers:
W_k shared by all graphs and heads, scaled by a scalar per (graph, head).
`cheb_filter_dynamic_per_node` is the packed rows' variant (`nn/packed.py`):
each node carries its own graph's W_k, so the graphs sharing a row are
filtered with their own weights under one block-diagonal Laplacian.

Summation order. `cheb_filter_dynamic`'s products reduce over the N nodes
twice: `Lhat Tx` in the forward (and its transpose in the backward), and
the weight gradient `Tx^T g` in the backward. On the card cuBLAS takes such
a float32 product over N = 2048 in one accumulator, in order, and rounded
3-7x worse than the CPU's blocked MKL product there (`chip_smoke.py
--precision`, PERF.md). `node_matmul` takes every contraction over the node
axis in blocks of NODE_BLOCK rows, each block's product (a plain
`torch.matmul`) a fresh partial, the partials summed after: the same
function, and the same summation order on every device. The GraphiT
layer's score route (`nn/layers.py`) takes its products over the keys and
queries through the same blocks (`node_matmul`, `head_sum_matmul`).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

NODE_BLOCK = 64


def blocked_matmul(a: torch.Tensor, b: torch.Tensor,
                   block: int = NODE_BLOCK) -> torch.Tensor:
    """a [..., M, K] @ b [..., K, N] (batch dims broadcast) with the
    contraction over K in blocks of `block`: one fresh partial product per
    block, then the sum of the partials."""
    k = a.shape[-1]
    if k <= block:
        return a @ b
    nb = -(-k // block)
    pad = nb * block - k
    if pad:
        a = F.pad(a, (0, pad))
        b = F.pad(b, (0, 0, 0, pad))
    ar = a.reshape(*a.shape[:-1], nb, block).movedim(-2, -3)
    br = b.reshape(*b.shape[:-2], nb, block, b.shape[-1])
    return (ar @ br).sum(-3)


def _sum_to(t: torch.Tensor, shape) -> torch.Tensor:
    """t summed over the batch dims that broadcasting expanded to it."""
    lead = t.dim() - len(shape)
    if lead:
        t = t.sum(tuple(range(lead)))
    dims = tuple(i for i, s in enumerate(shape) if s == 1 and t.shape[i] != 1)
    return t.sum(dims, keepdim=True) if dims else t


class NodeMatmul(torch.autograd.Function):
    """a @ b whose forward and both gradients take their contractions in
    blocks (`blocked_matmul`): the backward's a^T g reduces over a's rows,
    the nodes, where autograd's own product would take them in one sum."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return blocked_matmul(a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        da = db = None
        if ctx.needs_input_grad[0]:
            da = _sum_to(blocked_matmul(g, b.transpose(-1, -2)), a.shape)
        if ctx.needs_input_grad[1]:
            db = _sum_to(blocked_matmul(a.transpose(-1, -2), g), b.shape)
        return da, db


def node_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b with every contraction over the node axis in blocks of
    NODE_BLOCK rows, forward and backward. Where no contraction is longer
    than one block (small graphs, as ZINC's), it is the plain product with
    autograd's own backward: one op, no pads or reshapes."""
    if max(a.shape[-2], a.shape[-1], b.shape[-1]) <= NODE_BLOCK:
        return a @ b
    return NodeMatmul.apply(a, b)


def head_sum_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """sum_h a[:, h] @ b[:, h]: a [B, H, M, K], b [B, H, K, F] -> [B, M, F].
    Where K fits one block, one product over (head, K) as before; else
    each head's product over K through `node_matmul`, then the sum over
    the heads (a contraction of H·K terms would otherwise be one cuBLAS
    sum)."""
    if a.shape[-1] <= NODE_BLOCK:
        return torch.einsum("bhnm,bhmf->bnf", a, b)
    return node_matmul(a, b).sum(1)


def cheb_filter_dynamic(x: torch.Tensor, lhat: torch.Tensor,
                        weights: torch.Tensor,
                        bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x [B, H, N, Din], lhat [B, N, N], weights [B, H, K, Din, Dout],
    bias [Dout] -> [B, H, N, Dout]; every product through `node_matmul`."""
    k_order = weights.shape[2]
    lh = lhat[:, None]                                   # [B, 1, N, N]
    tx_prev = x
    out = node_matmul(tx_prev, weights[:, :, 0])
    if k_order > 1:
        tx_cur = node_matmul(lh, x)
        out = out + node_matmul(tx_cur, weights[:, :, 1])
        for k in range(2, k_order):
            tx_next = 2.0 * node_matmul(lh, tx_cur) - tx_prev
            out = out + node_matmul(tx_next, weights[:, :, k])
            tx_prev, tx_cur = tx_cur, tx_next
    if bias is not None:
        out = out + bias
    return out


def cheb_filter_dynamic_per_node(x: torch.Tensor, lhat: torch.Tensor,
                                 weights: torch.Tensor,
                                 bias: Optional[torch.Tensor] = None
                                 ) -> torch.Tensor:
    """x [B, H, N, Din], lhat [B, N, N], weights [B, H, N, K, Din, Dout]
    per node, bias [Dout] -> [B, H, N, Dout]. The Laplacian products sum
    over the nodes through `node_matmul`; each node's product with its own
    weights sums over Din only."""
    k_order = weights.shape[3]
    lh = lhat[:, None]                                   # [B, 1, N, N]
    per_node = lambda t, k: (t[..., None, :] @ weights[:, :, :, k])[..., 0, :]
    tx_prev = x
    out = per_node(tx_prev, 0)
    if k_order > 1:
        tx_cur = node_matmul(lh, x)
        out = out + per_node(tx_cur, 1)
        for k in range(2, k_order):
            tx_next = 2.0 * node_matmul(lh, tx_cur) - tx_prev
            out = out + per_node(tx_next, k)
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
