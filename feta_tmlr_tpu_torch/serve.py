"""Inference: a bucketed, windowed predictor over host graphs.

`Predictor.predict(graphs)` collates the graphs in chunks of `max_batch`
(the padded-dense layout of training, node counts rounded up to
`node_buckets` unless `max_nodes` fixes one size) and runs the model in
eval mode under `torch.inference_mode()`: dropout off, batch norm on its
running statistics, so graphs in one chunk do not influence each other.

  - the tail chunk is padded with copies of its first graph, so every
    dispatch has one shape per node bucket (the rows are dropped again);
  - up to `WINDOW` chunks are in flight: each chunk's input goes to the
    card from page-locked memory without a host sync, its logits come back
    into a page-locked buffer of their own (a fresh one from PyTorch's
    caching host allocator for every chunk, so concurrent calls share no
    buffer) with a CUDA event behind the copy, and the host waits on the
    oldest chunk's event only when the window is full, so chunk i's copy
    back overlaps the work of the chunks after it;
  - `warmup` runs one forward per bucket before traffic, which also builds
    the CUDA kernels at their first use, so no request pays for that;
  - weights come from the model or, with `ckpt_dir`, from the latest
    checkpoint that `Trainer.fit` wrote there (`train/checkpoint.py`).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from feta_tmlr_tpu_torch.data.batch import (
    _DEFAULT_NODE_BUCKETS,
    Graph,
    collate_graphs,
    pad_bucket,
)
from feta_tmlr_tpu_torch.device import resolve_device
from feta_tmlr_tpu_torch.train.checkpoint import CheckpointManager

WINDOW = 4          # chunks in flight per predict call


class Predictor:
    """Args:
      model: a module whose forward takes a `GraphBatch` and returns
        logits or a tuple whose first element is the logits ([B], [B, C]
        or [B, N, C]).
      device: where to serve (default CUDA; raises if CUDA is absent and
        the CPU was not asked for). The model is moved there.
      ckpt_dir: restore the model's weights from the latest checkpoint of
        a `Trainer.fit(ckpt_dir=...)` run.
      max_batch: graphs per forward call.
      node_buckets: padding buckets (default: the training buckets).
      collate_kwargs: passed to `collate_graphs` (e.g. `max_nodes`).
      node_level: per-node logits with padding stripped per graph, instead
        of one logit row per graph.
    """

    def __init__(self, model: torch.nn.Module, device=None,
                 ckpt_dir: Optional[str] = None, max_batch: int = 128,
                 node_buckets: Optional[Sequence[int]] = None,
                 collate_kwargs: Optional[dict] = None,
                 node_level: bool = False):
        self.device = resolve_device(device)
        if ckpt_dir is not None:
            model.load_state_dict(
                CheckpointManager(ckpt_dir).restore()["model"])
        self.model = model.to(self.device).eval()
        self.max_batch = max_batch
        self.node_buckets = node_buckets
        self.collate_kwargs = dict(collate_kwargs or {})
        self.node_level = node_level
        self.shapes = set()            # (B, N) of every dispatch so far

    def _forward(self, batch) -> torch.Tensor:
        """Logits of one collated host batch, left on the device."""
        self.shapes.add(tuple(batch.x.shape[:2]))
        if self.device.type == "cuda":
            batch = batch.pin_memory().to(self.device, non_blocking=True)
        with torch.inference_mode():
            out = self.model(batch)
        return out[0] if isinstance(out, tuple) else out

    def _to_host(self, logits: torch.Tensor):
        """Start the copy of `logits` into a new page-locked host tensor;
        returns it and the event that marks the copy done. On the CPU the
        logits are host memory already: (logits, None)."""
        if self.device.type != "cuda":
            return logits, None
        host = torch.empty(logits.shape, dtype=logits.dtype, pin_memory=True)
        host.copy_(logits, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return host, event

    def predict(self, graphs: Sequence[Graph]) -> np.ndarray:
        """Logits per graph, or per node (padding stripped), in input
        order. Ragged node-level outputs come back as an object array."""
        if not graphs:
            return np.zeros((0,), np.float32)
        kw = dict(self.collate_kwargs)
        if self.node_buckets is not None:
            kw.setdefault("node_buckets", self.node_buckets)
        outs = []
        in_flight = []                 # [(chunk, host logits, event)]

        def drain_one():
            chunk, host, event = in_flight.pop(0)
            if event is not None:
                event.synchronize()
            logits = host.numpy()
            if self.node_level:
                outs.extend(logits[i, : g.num_nodes]
                            for i, g in enumerate(chunk))
            else:
                outs.extend(logits[: len(chunk)])

        for lo in range(0, len(graphs), self.max_batch):
            chunk = list(graphs[lo: lo + self.max_batch])
            pad = [chunk[0]] * (self.max_batch - len(chunk))
            logits = self._forward(collate_graphs(chunk + pad, **kw))
            in_flight.append((chunk, *self._to_host(logits)))
            if len(in_flight) >= WINDOW:
                drain_one()
        while in_flight:
            drain_one()
        try:
            return np.stack(outs)
        except ValueError:                       # ragged node-level outputs
            return np.asarray(outs, dtype=object)

    def warmup(self, sample: Graph,
               buckets: Optional[Sequence[int]] = None) -> int:
        """One forward of `max_batch` copies of `sample` per node bucket
        that can hold it (the given `buckets`, else the fixed `max_nodes`,
        else `node_buckets` or the training buckets); builds the kernels
        and fills the allocator's caches before traffic. Returns the
        number of shapes run."""
        if buckets is not None:
            bks = list(buckets)
        elif self.collate_kwargs.get("max_nodes") is not None:
            bks = [self.collate_kwargs["max_nodes"]]
        else:
            bks = list(self.node_buckets or _DEFAULT_NODE_BUCKETS)
        n_run = 0
        for bucket in bks:
            if bucket < sample.num_nodes:
                continue
            kw = dict(self.collate_kwargs)
            kw["max_nodes"] = bucket
            kw.pop("node_buckets", None)
            self._forward(collate_graphs([sample] * self.max_batch, **kw))
            n_run += 1
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return n_run

    def compile_stats(self) -> dict:
        """The buckets and batch size this predictor serves, and the
        (graphs, nodes) shapes it has dispatched so far: the shapes whose
        kernels and allocations are warm."""
        return {"buckets": self.node_buckets or "default",
                "max_batch": self.max_batch,
                "shapes": sorted(self.shapes)}


def bucketize(graphs: Sequence[Graph],
              node_buckets: Optional[Sequence[int]] = None):
    """Group graphs by their padded bucket size, so that each group is
    served at one of the static shapes."""
    groups = {}
    for g in graphs:
        b = pad_bucket(g.num_nodes, node_buckets) if node_buckets \
            else pad_bucket(g.num_nodes)
        groups.setdefault(b, []).append(g)
    return groups
