"""Keep-latest checkpoints of a training run (`torch.save` /
`torch.load(weights_only=True)`).

A checkpoint is one dict of tensors and plain values,
`Trainer.state_dict()`: the model's `state_dict` (batch-norm buffers
included), the optimizer's state (its learning rate included), the
trainer's step count, the plateau scheduler's counters and the states of
the sign-flip and dropout generators. Step `s` lives in `<dir>/<s>/state.pt`,
written to a temporary name and renamed, so a directory holds only whole
checkpoints; after each save only the newest `max_to_keep` remain. A
save copies every tensor to host memory and writes the file before it
returns.
"""

from __future__ import annotations

import os
import shutil
from typing import Any, List, Optional

import torch

STATE_FILE = "state.pt"


def _to_host(obj: Any) -> Any:
    """A copy of obj with every tensor copied to host memory."""
    if torch.is_tensor(obj):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 2):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep

    def all_steps(self) -> List[int]:
        return sorted(int(name) for name in os.listdir(self.directory)
                      if name.isdigit() and os.path.isfile(
                          os.path.join(self.directory, name, STATE_FILE)))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: dict) -> None:
        step_dir = os.path.join(self.directory, str(step))
        os.makedirs(step_dir, exist_ok=True)
        path = os.path.join(step_dir, STATE_FILE)
        torch.save(_to_host(state), path + ".tmp")
        os.replace(path + ".tmp", path)
        for old in self.all_steps()[:-self.max_to_keep]:
            shutil.rmtree(os.path.join(self.directory, str(old)),
                          ignore_errors=True)

    def restore(self, step: Optional[int] = None) -> dict:
        """The checkpoint of `step` (default the latest), on the CPU."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self.directory}")
        return torch.load(os.path.join(self.directory, str(step), STATE_FILE),
                          map_location="cpu", weights_only=True)
