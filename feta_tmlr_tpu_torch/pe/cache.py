"""Disk cache of per-graph PE kernels: one compressed npz file per
(encoding parameters, split), written once and reused (`save` does nothing
when the file exists, as the reference's pickle caches)."""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np


class PECache:
    def __init__(self, cache_dir: str):
        self.cache_dir = cache_dir
        os.makedirs(cache_dir, exist_ok=True)

    def _path(self, key: str, split: str) -> str:
        return os.path.join(self.cache_dir, f"{key}.{split}.npz")

    def load(self, key: str, split: str) -> Optional[List[np.ndarray]]:
        path = self._path(key, split)
        if not os.path.isfile(path):
            return None
        with np.load(path) as z:
            return [z[f"pe_{i}"] for i in range(len(z.files))]

    def save(self, key: str, split: str, pes: List[np.ndarray]) -> None:
        path = self._path(key, split)
        if os.path.isfile(path):
            return
        np.savez_compressed(
            path, **{f"pe_{i}": p for i, p in enumerate(pes)})
