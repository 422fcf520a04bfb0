"""Trainer for the FeTA node classifier (the `node_clf` task).

The counterpart of the JAX package's `train/trainer.py` for the task the
port trains so far: masked cross-entropy over labelled real nodes plus the
weighted coefficient regularizer, class-balanced accuracy (SBM
PATTERN/CLUSTER). Reference behaviours kept: the Laplacian-PE sign-flip
augmentation during training, batch-norm running statistics updated in
train mode, best-val selection, and the constant / step / warmup / plateau
learning-rate schedules.

The trainer runs on the model's device (CUDA by default). PyTorch runs
eagerly, so a step is the model's forward, `backward()` through the
attention kernels' `autograd.Function`, and one AdamW update; losses stay
on the device until `train_epoch` takes their mean in one host sync.
"""

from __future__ import annotations

import copy
import dataclasses
import time
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from feta_tmlr_tpu_torch.data.batch import GraphBatch
from feta_tmlr_tpu_torch.train.metrics import accuracy_sbm
from feta_tmlr_tpu_torch.train.optim import (
    PlateauScheduler,
    make_optimizer,
    step_lr,
    warmup_inverse_sqrt,
)


@dataclasses.dataclass
class TrainConfig:
    task: str = "node_clf"             # the one task ported so far
    lr: float = 1e-3
    weight_decay: float = 1e-5
    epochs: int = 100
    regularization: float = 0.0
    sign_flip: bool = True             # lap-PE sign-flip augmentation
    schedule: str = "constant"         # constant | step | plateau | warmup
    grad_clip_norm: Optional[float] = None   # global-norm clip (off = ref)
    warmup_steps: int = 2000           # for schedule='warmup'
    step_size: int = 50                # StepLR epochs
    gamma: float = 0.5
    plateau_patience: int = 10
    plateau_factor: float = 0.5
    min_lr: float = 1e-6
    seed: int = 0


def _check_task(task: str) -> None:
    if task != "node_clf":
        raise ValueError(
            f"task {task!r} is not ported yet (ROADMAP Queue 1 item 2 and "
            "later); the port trains 'node_clf'")


def task_loss(task: str, logits: torch.Tensor,
              batch: GraphBatch) -> torch.Tensor:
    """Masked cross-entropy over real nodes with a label (y >= 0)."""
    _check_task(task)
    labels = batch.y.clamp_min(0).long()
    ce = -torch.log_softmax(logits, -1).gather(-1, labels[..., None])[..., 0]
    m = (batch.node_mask & (batch.y >= 0)).to(ce.dtype)
    return (ce * m).sum() / m.sum().clamp_min(1.0)


def task_metric(task: str, logits: np.ndarray, y, node_mask=None) -> dict:
    """Metric over a full split (logits and labels of all its batches)."""
    _check_task(task)
    return {"acc_sbm": accuracy_sbm(logits, y, mask=node_mask)}


class Trainer:
    """Train and evaluate one model on the `node_clf` task.

    The optimizer and the sign-flip generator (a CPU `torch.Generator`
    seeded from `config.seed`, so a seed gives the same signs on every
    device) live on the trainer; the weights live in the model."""

    def __init__(self, model: torch.nn.Module, config: TrainConfig,
                 steps_per_epoch: int = 1):
        _check_task(config.task)
        c = config
        self.model = model
        self.cfg = config
        self.device = next(model.parameters()).device
        self.optimizer = make_optimizer(model.parameters(), c.lr,
                                        c.weight_decay, c.grad_clip_norm)
        self.plateau = None
        self._schedule = None
        if c.schedule == "step":
            self._schedule = step_lr(c.lr, c.step_size, c.gamma,
                                     steps_per_epoch)
        elif c.schedule == "warmup":
            self._schedule = warmup_inverse_sqrt(c.lr, c.warmup_steps)
        elif c.schedule == "plateau":
            self.plateau = PlateauScheduler(
                factor=c.plateau_factor, patience=c.plateau_patience,
                mode="max", min_lr=c.min_lr)      # acc_sbm: higher is better
        elif c.schedule != "constant":
            raise ValueError(f"unknown schedule {c.schedule!r}")
        self.steps = 0
        self.sign_generator = torch.Generator().manual_seed(c.seed)

    def _set_lr(self, lr: float) -> None:
        for group in self.optimizer.param_groups:
            group["lr"] = lr

    def _sign_flip(self, batch: GraphBatch) -> GraphBatch:
        """Random sign per Laplacian-PE dimension (one draw per step)."""
        if not self.cfg.sign_flip or batch.lap_pe is None:
            return batch
        draw = torch.rand(batch.lap_pe.shape[-1],
                          generator=self.sign_generator)
        signs = torch.where(draw >= 0.5, 1.0, -1.0).to(batch.lap_pe.device)
        return dataclasses.replace(batch, lap_pe=batch.lap_pe * signs)

    def step(self, batch: GraphBatch) -> torch.Tensor:
        """One AdamW update on `batch`; returns the loss on the device.
        The parameters' `.grad` keep this step's gradients afterwards."""
        if self._schedule is not None:
            self._set_lr(self._schedule(self.steps))
        self.model.train()
        batch = self._sign_flip(batch)
        self.optimizer.zero_grad(set_to_none=True)
        logits, reg = self.model(batch,
                                 regularization=self.cfg.regularization)
        loss = (task_loss(self.cfg.task, logits, batch)
                + self.cfg.regularization * reg)
        loss.backward()
        self.optimizer.step()
        self.steps += 1
        return loss.detach()

    def train_epoch(self, batches: Sequence[GraphBatch]) -> float:
        """One step per batch; the mean loss, with one host sync."""
        losses = [self.step(b) for b in batches]
        return float(torch.stack(losses).mean())

    def evaluate(self, batches: Sequence[GraphBatch]) -> dict:
        """Split-level metrics over the concatenated predictions of all
        batches (node-level batches must share a padded length)."""
        self.model.eval()
        logits_all, y_all, mask_all = [], [], []
        with torch.inference_mode():
            for b in batches:
                logits, _ = self.model(b)
                logits_all.append(logits.cpu().numpy())
                y_all.append(b.y.cpu().numpy())
                mask_all.append(b.node_mask.cpu().numpy())
        return task_metric(self.cfg.task, np.concatenate(logits_all),
                           np.concatenate(y_all), np.concatenate(mask_all))

    def fit(self, train_batches: Sequence[GraphBatch],
            val_batches: Optional[Sequence[GraphBatch]] = None,
            test_batches: Optional[Sequence[GraphBatch]] = None,
            epochs: Optional[int] = None,
            log_fn: Optional[Callable[[dict], None]] = None) -> dict:
        """Train for `epochs` (default `cfg.epochs`); each epoch replays the
        training batches in an order from a numpy generator seeded with
        `cfg.seed` (the JAX trainer's order). With validation batches the
        model ends on its best-val weights, which are also returned.

        Returns {"history", "best_epoch", "best_val", "state"} and, with
        test batches, "test" (metrics of the returned weights)."""
        cfg = self.cfg
        on_device = lambda bs: [b.to(self.device) for b in bs]
        train = on_device(train_batches)
        val = on_device(val_batches) if val_batches is not None else None
        test = on_device(test_batches) if test_batches is not None else None
        history: List[dict] = []
        best_val, best_state, best_epoch = None, None, 0
        order_rng = np.random.default_rng(cfg.seed)
        for epoch in range(epochs or cfg.epochs):
            t0 = time.perf_counter()
            loss = self.train_epoch(
                [train[i] for i in order_rng.permutation(len(train))])
            row = {"epoch": epoch, "loss": loss,
                   "time": time.perf_counter() - t0}
            if val is not None:
                vm = self.evaluate(val)
                row.update({f"val_{k}": v for k, v in vm.items()})
                cur = next(iter(vm.values()))
                if (best_val is None or np.isnan(best_val)
                        or (not np.isnan(cur) and cur > best_val)):
                    best_val, best_epoch = cur, epoch
                    best_state = copy.deepcopy(self.model.state_dict())
                if self.plateau is not None:
                    row["lr"] = self.plateau.step(cur, cfg.lr)
                    self._set_lr(row["lr"])
            history.append(row)
            if log_fn:
                log_fn(row)
        if best_state is not None:
            self.model.load_state_dict(best_state)
        result = {"history": history, "best_epoch": best_epoch,
                  "best_val": best_val, "state": self.model.state_dict()}
        if test is not None:
            result["test"] = self.evaluate(test)
        return result
