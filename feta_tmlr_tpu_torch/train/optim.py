"""AdamW and learning-rate schedules matching the reference trainers.

`make_optimizer` is torch's AdamW with optax.adamw's constants (betas 0.9 /
0.999, eps 1e-8, decoupled decay on every parameter); the two apply the
same update, p <- p - lr * (m_hat / (sqrt(v_hat) + eps) + wd * p). The
schedules are host-side functions of the update count returning the
learning rate, which the trainer writes into the optimizer before each
step:

  step_lr              torch StepLR over epochs (TU cross-validation)
  warmup_inverse_sqrt  linear warmup, then lr * sqrt(warmup / step) (OGB, ZINC)
  PlateauScheduler     ReduceLROnPlateau, driven by validation metrics
"""

from __future__ import annotations

from typing import Iterable, Optional

import torch


def make_optimizer(params: Iterable[torch.nn.Parameter], lr: float,
                   weight_decay: float = 1e-5,
                   grad_clip_norm: Optional[float] = None
                   ) -> torch.optim.AdamW:
    """AdamW; with grad_clip_norm, each step first scales the gradients to
    that global norm (`clip_grad_norm_`, which divides by norm + 1e-6
    where optax divides by the norm)."""
    params = list(params)
    opt = torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=weight_decay)
    if grad_clip_norm is not None:
        def clip(*_):
            torch.nn.utils.clip_grad_norm_(params, grad_clip_norm)
        opt.register_step_pre_hook(clip)
    return opt


def step_lr(base_lr: float, step_size: int, gamma: float,
            steps_per_epoch: int):
    """Torch StepLR semantics: lr * gamma^(epoch // step_size)."""
    def schedule(count: int) -> float:
        epoch = count // steps_per_epoch
        return base_lr * gamma ** (epoch // step_size)
    return schedule


def warmup_inverse_sqrt(base_lr: float, warmup_steps: int,
                        floor: float = 1e-6):
    """Linear floor -> lr over `warmup_steps` updates, then
    lr * sqrt(warmup_steps / step)."""
    def schedule(count: int) -> float:
        s = max(float(count), 1.0)
        if s < warmup_steps:
            return floor + s * (base_lr - floor) / max(warmup_steps, 1)
        return base_lr * warmup_steps ** 0.5 * s ** -0.5
    return schedule


class PlateauScheduler:
    """Host-side ReduceLROnPlateau (torch semantics, mode min/max)."""

    def __init__(self, factor: float = 0.5, patience: int = 10,
                 mode: str = "min", min_lr: float = 1e-6,
                 threshold: float = 1e-4):
        self.factor = factor
        self.patience = patience
        self.mode = mode
        self.min_lr = min_lr
        self.threshold = threshold
        self.best = None
        self.bad_epochs = 0
        self.scale = 1.0

    def step(self, metric: float, base_lr: float) -> float:
        # threshold_mode 'rel': min: a < best * (1 - th); max: a > best * (1 + th)
        better = (
            self.best is None
            or (self.mode == "min"
                and metric < self.best * (1.0 - self.threshold))
            or (self.mode == "max"
                and metric > self.best * (1.0 + self.threshold))
        )
        if better:
            self.best = metric
            self.bad_epochs = 0
        else:
            self.bad_epochs += 1
            if self.bad_epochs > self.patience:
                self.scale *= self.factor
                self.bad_epochs = 0
        return max(base_lr * self.scale, self.min_lr)
