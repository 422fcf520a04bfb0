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

`fit` keeps per-epoch checkpoints (`train/checkpoint.py`) and resumes the
uninterrupted trajectory from them exactly: every piece of state a step
reads (weights, batch-norm statistics, optimizer moments and learning
rate, step count, plateau counters, the sign-flip and dropout generators
and the epoch order) is saved or replayed.
"""

from __future__ import annotations

import copy
import dataclasses
import inspect
import json
import os
import time
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from feta_tmlr_tpu_torch.data.batch import GraphBatch
from feta_tmlr_tpu_torch.train.checkpoint import CheckpointManager
from feta_tmlr_tpu_torch.train.losses import sample_cross_entropy
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
    # the reference's stop conditions: stop once the plateau schedule has
    # reached min_lr / after max_time_h hours of training
    stop_at_min_lr: bool = False
    max_time_h: Optional[float] = None
    binary_metric: str = "ap"    # binary_graph, several tasks: ap | rocauc
    # after each epoch, raise NonFiniteError if the mean loss or any
    # parameter is non-finite or a parameter exceeds 1000 in magnitude
    # (one host transfer an epoch; off, no step syncs the host)
    debug_nan: bool = False
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
    1). A packed batch (`graph_mask` [B, G]; logits [B, G, C], y [B, G])
    takes graph_reg's and graph_clf's means over its valid slots."""
    _check_task(task)
    if task in ("graph_reg", "graph_clf"):
        per = ((logits.reshape(batch.y.shape) - batch.y).abs()
               if task == "graph_reg"
               else sample_cross_entropy(logits, batch.y))
        if getattr(batch, "graph_mask", None) is None:
            return per.mean()
        m = batch.graph_mask.to(per.dtype)
        return (per * m).sum() / m.sum().clamp_min(1.0)
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
        batches (node-level batches must share a padded length; a packed
        batch gives the predictions of its valid graph slots)."""
        self.model.eval()
        logits_all, y_all, mask_all = [], [], []
        with torch.inference_mode():
            for b in batches:
                logits, _ = _model_outputs(self.model(b))
                logits, y = logits.cpu().numpy(), b.y.cpu().numpy()
                if b.graph_mask is not None:
                    valid = b.graph_mask.cpu().numpy().reshape(-1)
                    logits = logits.reshape((-1,) + logits.shape[2:])[valid]
                    y = y.reshape((-1,) + y.shape[2:])[valid]
                else:
                    mask_all.append(b.node_mask.cpu().numpy())
                logits_all.append(logits)
                y_all.append(y)
        return task_metric(self.cfg.task, np.concatenate(logits_all),
                           np.concatenate(y_all),
                           np.concatenate(mask_all) if mask_all else None,
                           binary_metric=self.cfg.binary_metric)

    def state_dict(self) -> dict:
        """Everything a training step reads besides the batches: the
        checkpoint `fit` saves (tensors stay where they are; the
        checkpoint manager copies them to the host)."""
        dropout_generator = getattr(self.model, "dropout_generator", None)
        return {
            "model": self.model.state_dict(),
            "optimizer": self.optimizer.state_dict(),
            "steps": self.steps,
            "plateau": (None if self.plateau is None else
                        {"best": self.plateau.best,
                         "bad_epochs": self.plateau.bad_epochs,
                         "scale": self.plateau.scale}),
            "sign_generator": self.sign_generator.get_state(),
            "dropout_generator": (None if dropout_generator is None
                                  else dropout_generator.get_state()),
        }

    def load_state_dict(self, state: dict) -> None:
        self.model.load_state_dict(state["model"])
        self.optimizer.load_state_dict(state["optimizer"])
        self.steps = int(state["steps"])
        if self.plateau is not None and state["plateau"] is not None:
            self.plateau.best = state["plateau"]["best"]
            self.plateau.bad_epochs = state["plateau"]["bad_epochs"]
            self.plateau.scale = state["plateau"]["scale"]
        self.sign_generator.set_state(state["sign_generator"])
        dropout_generator = getattr(self.model, "dropout_generator", None)
        if dropout_generator is not None \
                and state["dropout_generator"] is not None:
            dropout_generator.set_state(state["dropout_generator"])

    def _better(self, cur: float, best: Optional[float]) -> bool:
        return (best is None or np.isnan(best)
                or (not np.isnan(cur)
                    and (cur < best if self._mode == "min" else cur > best)))

    def _write_meta(self, path: str, epoch: int, best_val, best_epoch: int
                    ) -> None:
        """The `fit_meta.json` sidecar of each checkpoint: the host-side
        loop state (the JAX package's layout)."""
        meta = {"epoch": epoch,
                "best_val": None if best_val is None else float(best_val),
                "best_epoch": best_epoch}
        if self.plateau is not None:
            meta.update(plateau_best=(None if self.plateau.best is None
                                      else float(self.plateau.best)),
                        plateau_bad=self.plateau.bad_epochs,
                        plateau_scale=self.plateau.scale)
        with open(path + ".tmp", "w") as f:
            json.dump(meta, f)
        os.replace(path + ".tmp", path)

    def fit(self, train_batches: Sequence[GraphBatch],
            val_batches: Optional[Sequence[GraphBatch]] = None,
            test_batches: Optional[Sequence[GraphBatch]] = None,
            epochs: Optional[int] = None,
            log_fn: Optional[Callable[[dict], None]] = None,
            rebatch_fn: Optional[Callable[[int], Sequence[GraphBatch]]]
            = None,
            ckpt_dir: Optional[str] = None,
            resume: bool = False) -> dict:
        """Train for `epochs` (default `cfg.epochs`); each epoch replays the
        training batches in an order from a numpy generator seeded with
        `cfg.seed` (the JAX trainer's order), or, with `rebatch_fn`, the
        batches `rebatch_fn(epoch)` returns from the second epoch on. With
        validation batches the model ends on its best-val weights, which
        are also returned.

        ckpt_dir: a checkpoint of `state_dict()` after every epoch (the
        newest two kept), with a `fit_meta.json` sidecar holding best_val,
        best_epoch and the plateau counters. resume=True continues from
        the latest checkpoint there: the trainer's state comes from the
        checkpoint, best_val / best_epoch from the sidecar, the best
        weights from the best epoch's checkpoint while it is kept (else
        the resume point's, as in the JAX package), and the epoch-order
        generator is replayed through the finished epochs, so the run
        continues the uninterrupted one exactly.

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
        ckpt = meta_path = None
        if ckpt_dir is not None:
            ckpt = CheckpointManager(ckpt_dir, max_to_keep=2)
            meta_path = os.path.join(ckpt.directory, "fit_meta.json")
        start_epoch = 0
        if resume and ckpt is not None and ckpt.latest_step() is not None:
            last = ckpt.latest_step()
            self.load_state_dict(ckpt.restore(last))
            start_epoch = last + 1
            if os.path.isfile(meta_path):
                with open(meta_path) as f:
                    meta = json.load(f)
                best_val = meta.get("best_val")
                best_epoch = meta.get("best_epoch", last)
            if best_val is not None:
                best_state = (ckpt.restore(best_epoch)["model"]
                              if best_epoch in ckpt.all_steps()
                              else copy.deepcopy(self.model.state_dict()))
            for _ in range(start_epoch):
                order_rng.permutation(len(train))
        t_start = time.perf_counter()
        try:
            for epoch in range(start_epoch, epochs or cfg.epochs):
                t0 = time.perf_counter()
                if rebatch_fn is not None and epoch > 0:
                    train = on_device(rebatch_fn(epoch))
                loss = self.train_epoch(
                    [train[i] for i in order_rng.permutation(len(train))])
                row = {"epoch": epoch, "loss": loss,
                       "time": time.perf_counter() - t0}
                if cfg.debug_nan:
                    _check_finite(self.model, loss, epoch)
                if val is not None:
                    vm = self.evaluate(val)
                    row.update({f"val_{k}": v for k, v in vm.items()})
                    cur = next(iter(vm.values()))
                    if self._better(cur, best_val):
                        best_val, best_epoch = cur, epoch
                        best_state = copy.deepcopy(self.model.state_dict())
                    if self.plateau is not None:
                        row["lr"] = self.plateau.step(cur, cfg.lr)
                        self._set_lr(row["lr"])
                history.append(row)
                if log_fn:
                    log_fn(row)
                if ckpt is not None:
                    ckpt.save(epoch, self.state_dict())
                    self._write_meta(meta_path, epoch, best_val, best_epoch)
                if (cfg.stop_at_min_lr and self.plateau is not None
                        and row.get("lr", cfg.lr) <= cfg.min_lr):
                    print("lr <= min_lr, stopping")
                    break
                if (cfg.max_time_h is not None
                        and time.perf_counter() - t_start
                        > cfg.max_time_h * 3600):
                    print("max_time reached, stopping")
                    break
        except KeyboardInterrupt:
            # the reference's catch: finish on the best state so far
            print("interrupted, exiting from training early")
        if best_state is not None:
            self.model.load_state_dict(best_state)
        result = {"history": history, "best_epoch": best_epoch,
                  "best_val": best_val, "state": self.model.state_dict()}
        if test is not None:
            result["test"] = self.evaluate(test)
        return result


class NonFiniteError(RuntimeError):
    """Raised under `TrainConfig.debug_nan` when training diverges; the
    message names the offending parameters."""


def _check_finite(model: torch.nn.Module, loss: float, epoch: int) -> None:
    if not np.isfinite(loss):
        raise NonFiniteError(f"non-finite loss {loss} at epoch {epoch}")
    named = [(n, p.detach()) for n, p in model.named_parameters()
             if p.numel()]
    with torch.no_grad():           # one device -> host transfer
        stats = torch.stack([torch.stack(
            [torch.isfinite(p).all().float(), p.abs().max().float()])
            for _, p in named]).cpu().numpy()
    bad = []
    for (name, _), (finite, amax) in zip(named, stats):
        if not finite:
            bad.append(f"{name}: nan/inf")
        elif amax > 1000:           # the reference's explosion threshold
            bad.append(f"{name}: max|p|={amax:.1f}")
    if bad:
        raise NonFiniteError(
            f"epoch {epoch}: bad parameters\n  " + "\n  ".join(bad))
