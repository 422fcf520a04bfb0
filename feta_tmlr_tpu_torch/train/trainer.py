"""Trainer for the four tasks of the JAX package's `train/trainer.py`.

  node_clf      masked cross-entropy over labelled real nodes; class-
                balanced accuracy (SBM PATTERN/CLUSTER)
  graph_reg     L1 loss; MAE (ZINC, PCQM4M)
  graph_clf     cross-entropy of one logit row per graph; accuracy (TU)
  binary_graph  sigmoid binary cross-entropy over the labelled entries
                (NaN labels are unlabelled, molpcba); ROC-AUC for one task
                (molhiv), else the mean over tasks of AP or ROC-AUC
                (`TrainConfig.binary_metric`)

each plus the weighted coefficient regularizer. Reference behaviours kept:
the Laplacian-PE and eigenvector sign-flip augmentations during training,
batch-norm running statistics updated in train mode, best-val selection
(lower is better for `graph_reg`, higher for the others), and the
constant / step / warmup / plateau learning-rate schedules.

Models may return the logits or a tuple (logits, reg, ...), and take the
`regularization` keyword only if their forward has it, as in the JAX
trainer. The trainer runs on the model's device (CUDA by default). PyTorch
runs eagerly, so a step is the model's forward, `backward()` through the
kernels' `autograd.Function`s, and one AdamW update; losses stay on the
device until `train_epoch` takes their mean in one host sync.
"""

from __future__ import annotations

import copy
import dataclasses
import inspect
import time
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from feta_tmlr_tpu_torch.data.batch import GraphBatch
from feta_tmlr_tpu_torch.train.losses import (cross_entropy,
                                              sample_cross_entropy)
from feta_tmlr_tpu_torch.train.metrics import (
    accuracy_graph,
    accuracy_sbm,
    average_precision,
    mae,
    multitask_mean,
    roc_auc,
)
from feta_tmlr_tpu_torch.train.optim import (
    PlateauScheduler,
    make_optimizer,
    step_lr,
    warmup_inverse_sqrt,
)

TASKS = ("node_clf", "graph_reg", "graph_clf", "binary_graph")


@dataclasses.dataclass
class TrainConfig:
    task: str = "node_clf"             # one of TASKS
    lr: float = 1e-3
    weight_decay: float = 1e-5
    epochs: int = 100
    regularization: float = 0.0
    sign_flip: bool = True             # lap-PE / eigvec sign-flip augmentation
    schedule: str = "constant"         # constant | step | plateau | warmup
    grad_clip_norm: Optional[float] = None   # global-norm clip (off = ref)
    warmup_steps: int = 2000           # for schedule='warmup'
    step_size: int = 50                # StepLR epochs
    gamma: float = 0.5
    plateau_patience: int = 10
    plateau_factor: float = 0.5
    min_lr: float = 1e-6
    binary_metric: str = "ap"    # binary_graph, several tasks: ap | rocauc
    seed: int = 0


def _check_task(task: str) -> None:
    if task not in TASKS:
        raise ValueError(f"unknown task {task!r}; the trainer takes "
                         f"{', '.join(TASKS)}")


def _model_outputs(out):
    """Models return logits or (logits, reg) or (logits, reg, ...)."""
    if isinstance(out, tuple):
        return out[0], (out[1] if len(out) > 1 else 0.0)
    return out, 0.0


def task_loss(task: str, logits: torch.Tensor,
              batch: GraphBatch) -> torch.Tensor:
    """node_clf: masked cross-entropy over real nodes with a label
    (y >= 0); graph_reg: mean absolute error of one output per graph;
    graph_clf: mean cross-entropy of one logit row per graph;
    binary_graph: sigmoid binary cross-entropy with logits, summed over the
    entries whose label is not NaN and divided by their count (at least
    1)."""
    _check_task(task)
    if task == "graph_reg":
        return (logits.reshape(batch.y.shape) - batch.y).abs().mean()
    if task == "graph_clf":
        return cross_entropy(logits, batch.y, logits.shape[-1])
    if task == "binary_graph":
        y = batch.y.to(logits.dtype)
        if y.dim() < logits.dim():
            y = y[..., None]
        valid = ~torch.isnan(y)
        per = F.binary_cross_entropy_with_logits(
            logits, torch.where(valid, y, torch.zeros_like(y)),
            reduction="none")
        per = torch.where(valid, per, torch.zeros_like(per))
        return per.sum() / valid.sum().clamp_min(1)
    ce = sample_cross_entropy(logits, batch.y.clamp_min(0))
    m = (batch.node_mask & (batch.y >= 0)).to(ce.dtype)
    return (ce * m).sum() / m.sum().clamp_min(1.0)


def task_metric(task: str, logits: np.ndarray, y, node_mask=None,
                binary_metric: str = "ap") -> dict:
    """Metric over a full split (logits and labels of all its batches:
    ROC-AUC and AP do not decompose over batches)."""
    _check_task(task)
    if task == "graph_reg":
        return {"mae": mae(np.asarray(logits).reshape(np.shape(y)), y)}
    if task == "graph_clf":
        return {"acc": accuracy_graph(logits, y)}
    if task == "binary_graph":
        y = np.asarray(y)
        s = np.asarray(logits)
        if s.ndim == 1 or s.shape[-1] == 1:
            return {"rocauc": roc_auc(s.reshape(-1), y.reshape(-1))}
        if y.ndim < s.ndim:
            y = y[..., None]
        if binary_metric == "rocauc":
            return {"rocauc": multitask_mean(roc_auc, s, y)}
        return {"ap": multitask_mean(average_precision, s, y)}
    return {"acc_sbm": accuracy_sbm(logits, y, mask=node_mask)}


class Trainer:
    """Train and evaluate one model on one task.

    The optimizer and the sign-flip generator (a CPU `torch.Generator`
    seeded from `config.seed`, so a seed gives the same signs on every
    device) live on the trainer; the weights live in the model. A model
    with a `dropout_generator` (the SAN models) has it reseeded from
    `config.seed` too."""

    def __init__(self, model: torch.nn.Module, config: TrainConfig,
                 steps_per_epoch: int = 1):
        _check_task(config.task)
        c = config
        self.model = model
        self.cfg = config
        self.device = next(model.parameters()).device
        self._model_takes_reg = ("regularization" in inspect.signature(
            model.forward).parameters)
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
                mode=self._mode, min_lr=c.min_lr)
        elif c.schedule != "constant":
            raise ValueError(f"unknown schedule {c.schedule!r}")
        self.steps = 0
        self.sign_generator = torch.Generator().manual_seed(c.seed)
        dropout_generator = getattr(model, "dropout_generator", None)
        if dropout_generator is not None:
            dropout_generator.manual_seed(c.seed)

    @property
    def _mode(self) -> str:
        """Whether a lower ("min", MAE) or higher ("max": accuracy,
        ROC-AUC, AP) metric is better."""
        return "min" if self.cfg.task == "graph_reg" else "max"

    def _set_lr(self, lr: float) -> None:
        for group in self.optimizer.param_groups:
            group["lr"] = lr

    def _signs(self, t: torch.Tensor) -> torch.Tensor:
        """Signs drawn on the host, sent to a card from pinned memory
        without a sync."""
        draw = torch.rand(t.shape[-1], generator=self.sign_generator)
        signs = torch.where(draw >= 0.5, 1.0, -1.0).to(t.dtype)
        if t.device.type == "cuda":
            return signs.pin_memory().to(t.device, non_blocking=True)
        return signs.to(t.device)

    def _sign_flip(self, batch: GraphBatch) -> GraphBatch:
        """Random sign per Laplacian-PE dimension and, separately, per
        eigenvector (one draw of each per step)."""
        if not self.cfg.sign_flip:
            return batch
        flips = {name: t * self._signs(t) for name, t in
                 (("lap_pe", batch.lap_pe), ("eigvecs", batch.eigvecs))
                 if t is not None}
        return dataclasses.replace(batch, **flips) if flips else batch

    def step(self, batch: GraphBatch) -> torch.Tensor:
        """One AdamW update on `batch`; returns the loss on the device.
        The parameters' `.grad` keep this step's gradients afterwards."""
        if self._schedule is not None:
            self._set_lr(self._schedule(self.steps))
        self.model.train()
        batch = self._sign_flip(batch)
        self.optimizer.zero_grad(set_to_none=True)
        kwargs = ({"regularization": self.cfg.regularization}
                  if self.cfg.regularization > 0 and self._model_takes_reg
                  else {})
        logits, reg = _model_outputs(self.model(batch, **kwargs))
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
                logits, _ = _model_outputs(self.model(b))
                logits_all.append(logits.cpu().numpy())
                y_all.append(b.y.cpu().numpy())
                mask_all.append(b.node_mask.cpu().numpy())
        return task_metric(self.cfg.task, np.concatenate(logits_all),
                           np.concatenate(y_all), np.concatenate(mask_all),
                           binary_metric=self.cfg.binary_metric)

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
                        or (not np.isnan(cur)
                            and (cur < best_val if self._mode == "min"
                                 else cur > best_val))):
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
