"""Scalar logging, the `accelerator.log` equivalent
(ldm/train_unconditional.py:587-591): every scalar dict goes to a jsonl
stream and, when asked, to a Lightning-CSVLogger-style metrics.csv (header =
union of keys, rewritten when new keys appear). The JAX package's
TensorBoard and wandb sinks are not ported.
"""

from __future__ import annotations

import csv as csv_mod
import json
import os
from typing import Dict


class ScalarLogger:
    """Appends to <out_dir>/train_log.jsonl and, with csv=True,
    <out_dir>/metrics.csv; each write is closed before `log` returns."""

    def __init__(self, out_dir: str, csv: bool = False):
        os.makedirs(out_dir, exist_ok=True)
        self.jsonl_path = os.path.join(out_dir, "train_log.jsonl")
        self.csv_path = os.path.join(out_dir, "metrics.csv") if csv else None
        self._csv_keys: list = []
        self._csv_rows: list = []
        if self.csv_path and os.path.exists(self.csv_path):
            # a resumed run appends to the previous rows instead of
            # truncating them at its first new key
            with open(self.csv_path, newline="") as f:
                reader = csv_mod.DictReader(f)
                self._csv_keys = list(reader.fieldnames or [])
                self._csv_rows = list(reader)

    def _write_csv(self, rec: Dict[str, float]) -> None:
        self._csv_rows.append(rec)
        new_keys = [k for k in rec if k not in self._csv_keys]
        if new_keys:
            self._csv_keys.extend(new_keys)
            with open(self.csv_path, "w", newline="") as f:
                w = csv_mod.DictWriter(f, fieldnames=self._csv_keys)
                w.writeheader()
                w.writerows(self._csv_rows)
        else:
            with open(self.csv_path, "a", newline="") as f:
                csv_mod.DictWriter(f, fieldnames=self._csv_keys).writerow(rec)

    def log(self, step: int, scalars: Dict[str, float]) -> None:
        rec = {k: float(v) for k, v in scalars.items()}
        rec["step"] = int(step)
        with open(self.jsonl_path, "a") as f:
            f.write(json.dumps(rec) + "\n")
        if self.csv_path is not None:
            self._write_csv(rec)
