"""Embedding lookups whose table gradient is the same bits run to run.

`nn.Embedding`'s backward on the card sums the rows of one id with
atomics once a batch passes ~3,000 ids, in an order that changes from run
to run, so that a resumed run would not be the uninterrupted one bit for
bit. `Lookup` sums them as the one-hot product onehot(ids)^T @ g, which
sums in a fixed order; `OneHotEmbedding` is an `nn.Embedding` (same
parameter name `weight`, so checkpoints and `convert.from_flax` load as
before) whose forward goes through it.
"""

from __future__ import annotations

import torch
from torch import nn


class Lookup(torch.autograd.Function):
    """weight[ids], whose weight gradient is the one-hot product
    onehot(ids)^T @ g ([V, R] @ [R, D])."""

    @staticmethod
    def forward(ctx, weight, ids):
        ctx.save_for_backward(ids)
        ctx.vocab = weight.shape[0]
        return weight[ids]

    @staticmethod
    def backward(ctx, g):
        (ids,) = ctx.saved_tensors
        flat = ids.reshape(-1, 1)
        onehot = (flat == torch.arange(ctx.vocab, device=ids.device)
                  ).to(g.dtype)                          # [R, V]
        return onehot.t() @ g.reshape(flat.shape[0], -1), None


class OneHotEmbedding(nn.Embedding):
    """`nn.Embedding` whose table gradient is `Lookup`'s one-hot product."""

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return Lookup.apply(self.weight, ids)
