"""Inference: a batched predictor over host graphs.

`Predictor.predict(graphs)` collates the graphs in chunks of `max_batch`
(the same padded-dense layout as training), moves each chunk to the
model's device and runs the model in eval mode under
`torch.inference_mode()`: dropout off, batch norm on its running
statistics, so graphs in one chunk do not influence each other.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from feta_tmlr_tpu_torch.data.batch import Graph, collate_graphs
from feta_tmlr_tpu_torch.device import resolve_device


class Predictor:
    """Args:
      model: a module whose forward takes a `GraphBatch` and returns
        logits or a tuple whose first element is the logits.
      device: where to serve (default CUDA; raises if CUDA is absent and
        the CPU was not asked for). The model is moved there.
      max_batch: graphs per forward call.
      collate_kwargs: passed to `collate_graphs` (e.g. `max_nodes`).
      node_level: per-node logits with padding stripped per graph, instead
        of one logit row per graph.
    """

    def __init__(self, model: torch.nn.Module, device=None,
                 max_batch: int = 128,
                 collate_kwargs: Optional[dict] = None,
                 node_level: bool = False):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.max_batch = max_batch
        self.collate_kwargs = dict(collate_kwargs or {})
        self.node_level = node_level

    def predict(self, graphs: Sequence[Graph]) -> np.ndarray:
        """Logits per graph, or per node (padding stripped), in input
        order. Ragged node-level outputs come back as an object array."""
        if not graphs:
            return np.zeros((0,), np.float32)
        outs = []
        for lo in range(0, len(graphs), self.max_batch):
            chunk = list(graphs[lo: lo + self.max_batch])
            batch = collate_graphs(chunk, **self.collate_kwargs)
            with torch.inference_mode():
                out = self.model(batch.to(self.device))
                logits = (out[0] if isinstance(out, tuple) else out).cpu()
            logits = logits.numpy()
            if self.node_level:
                outs.extend(logits[i, : g.num_nodes]
                            for i, g in enumerate(chunk))
            else:
                outs.extend(logits[: len(chunk)])
        try:
            return np.stack(outs)
        except ValueError:                       # ragged node-level outputs
            return np.asarray(outs, dtype=object)
