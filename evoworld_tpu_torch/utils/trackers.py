"""Scalar metric trackers for training runs.

Counterpart of `evoworld_tpu/utils/trackers.py`: scalars stream to
`<output_dir>/<run_name>_metrics.jsonl` (one record per log event) with a
CSV mirror alongside. The sink is file-based; it needs no external service.
"""

from __future__ import annotations

import json
import os
import time
from typing import Mapping


class JSONLTracker:
    """Append-only JSONL + CSV scalar sink."""

    def __init__(self, output_dir: str, run_name: str = "train"):
        os.makedirs(output_dir, exist_ok=True)
        self.jsonl_path = os.path.join(output_dir, f"{run_name}_metrics.jsonl")
        self.csv_path = os.path.join(output_dir, f"{run_name}_metrics.csv")
        self._csv_header: list[str] | None = None
        if os.path.exists(self.csv_path):
            with open(self.csv_path) as f:
                first = f.readline().strip()
            self._csv_header = first.split(",") if first else None
        self._t0 = time.time()

    def log(self, step: int, scalars: Mapping[str, float]) -> None:
        record = {"step": int(step), "wall_s": round(time.time() - self._t0, 3)}
        record.update({k: float(v) for k, v in scalars.items()})
        with open(self.jsonl_path, "a") as f:
            f.write(json.dumps(record) + "\n")
        keys = list(record)
        if self._csv_header is None:
            self._csv_header = keys
            with open(self.csv_path, "a") as f:
                f.write(",".join(keys) + "\n")
        with open(self.csv_path, "a") as f:
            f.write(",".join(str(record.get(k, "")) for k in self._csv_header) + "\n")

    def log_artifact(self, step: int, kind: str, path: str) -> None:
        with open(self.jsonl_path, "a") as f:
            f.write(json.dumps({"step": int(step), "artifact": kind, "path": path}) + "\n")
