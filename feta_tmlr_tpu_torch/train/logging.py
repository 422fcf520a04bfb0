"""Per-epoch metrics as CSV files with the reference's layout: `logs.csv`
(one row per epoch) and `results.csv` (the final summary), written with
the stdlib csv module. The JAX package's `TensorBoardLogger` is not
ported (it needs a package the card's machine lacks)."""

from __future__ import annotations

import csv
import os
from typing import Dict, List


class CSVLogger:
    def __init__(self, outdir: str):
        self.outdir = outdir
        os.makedirs(outdir, exist_ok=True)
        self.rows: List[Dict] = []

    def log(self, row: Dict) -> None:
        self.rows.append(dict(row))

    def flush(self, filename: str = "logs.csv") -> str:
        """Write every row logged so far; the columns are the union of the
        rows' keys in first-seen order."""
        path = os.path.join(self.outdir, filename)
        if not self.rows:
            return path
        keys: List[str] = []
        for r in self.rows:
            keys.extend(k for k in r if k not in keys)
        with open(path, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=keys)
            w.writeheader()
            w.writerows(self.rows)
        return path

    def write_results(self, results: Dict,
                      filename: str = "results.csv") -> str:
        path = os.path.join(self.outdir, filename)
        with open(path, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=list(results.keys()))
            w.writeheader()
            w.writerow(results)
        return path
