"""Loss functions beyond the task defaults, on tensors.

`hinge_loss` is the one-vs-all squared multi-class hinge of the GCKN
reference (gckn/loss.py:8-43), with an optional per-class weight;
`cross_entropy` the mean softmax cross-entropy with an optional
per-sample weight, over `sample_cross_entropy`, which the trainer's task
losses also take; `LOSS` the reference's {'ce', 'hinge'} registry. The
counterparts of the JAX package's `train/losses.py`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def hinge_loss(logits, labels, n_classes: int, weight=None,
               squared: bool = True, margin: float = 1.0):
    """mean over samples of sum over classes of 0.5 * relu(margin -
    sign * logit)^2 (sign +1 for the sample's class, -1 otherwise; without
    `squared` the relu itself), each class's term times `weight[c]`."""
    signs = 2.0 * F.one_hot(labels.long(), n_classes).to(logits.dtype) - 1.0
    err = torch.relu(margin - signs * logits)
    if squared:
        err = 0.5 * err ** 2
    if weight is not None:
        err = err * torch.as_tensor(weight, dtype=err.dtype,
                                    device=err.device)[None, :]
    return err.sum(-1).mean()


def sample_cross_entropy(logits, labels):
    """-log softmax(logits)[label] of each sample, unreduced: [...] from
    logits [..., C] and labels [...]."""
    return -torch.log_softmax(logits, -1).gather(
        -1, labels.long()[..., None])[..., 0]


def cross_entropy(logits, labels, n_classes: int, weight=None):
    """mean over samples of -log softmax(logits)[label], each sample's term
    times `weight[i]`; `n_classes` is the logits' last width."""
    if logits.shape[-1] != n_classes:
        raise ValueError(f"logits of width {logits.shape[-1]} for "
                         f"{n_classes} classes")
    per_sample = sample_cross_entropy(logits, labels)
    if weight is not None:
        per_sample = per_sample * torch.as_tensor(
            weight, dtype=per_sample.dtype, device=per_sample.device)
    return per_sample.mean()


LOSS = {"ce": cross_entropy, "hinge": hinge_loss}
