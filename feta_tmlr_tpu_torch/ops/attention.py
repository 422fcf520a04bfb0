"""GraphiT kernel-modulated attention chain on precomputed scores.

The dense specification that both attention kernels must equal:

  p = softmax(scores masked over keys)
  p = p * pe * degree          (relative PE kernel, per-key rescale)
  p = p / sum_k p              (renormalised; eps-guarded denominator)
  p = p * qmask * kmask

With a pair mask (packed rows, `nn/packed.py`) the admissible keys of a
query are those of its own graph: the others take -1e30 before the softmax,
and after the chain the rows of padded queries and the inadmissible cells
are zeroed. No kernel takes a pair mask: this plain chain is the packed
rows' route on every device, as in the JAX package.
"""

from __future__ import annotations

from typing import Optional

import torch

_NEG_INF = -1e30
_EPS = 1e-9


def modulated_attention_from_scores(
    scores: torch.Tensor,
    v: Optional[torch.Tensor],
    node_mask: torch.Tensor,
    pe: Optional[torch.Tensor] = None,
    degree: Optional[torch.Tensor] = None,
    pair_mask: Optional[torch.Tensor] = None,
):
    """scores [B, H, N, N] (already scaled by 1/sqrt(dh)), v [B, H, N, dv]
    or None, pair_mask [B, N, N] bool (query, key) or None.

    Returns (out [B, H, N, dv] or None when v is None, attn [B, H, N, N])."""
    admissible = (node_mask.bool()[:, None, None, :] if pair_mask is None
                  else pair_mask.bool()[:, None])
    scores = torch.where(admissible, scores,
                         torch.full_like(scores, _NEG_INF))
    m = scores.amax(-1, keepdim=True)
    e = torch.exp(scores - m)
    attn = e / e.sum(-1, keepdim=True)
    if pe is not None:
        attn = attn * pe[:, None, :, :].to(attn.dtype)
    if degree is not None:
        attn = attn * degree[:, None, None, :].to(attn.dtype)
    if pe is not None or degree is not None:
        denom = attn.sum(-1, keepdim=True)
        attn = attn / torch.where(denom.abs() > _EPS, denom,
                                  torch.ones_like(denom))
    mask = node_mask.to(attn.dtype)
    attn = attn * mask[:, None, :, None] * (
        mask[:, None, None, :] if pair_mask is None
        else admissible.to(attn.dtype))
    return (None if v is None else attn @ v), attn
