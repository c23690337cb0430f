"""Metric logging: JSONL always (machine-readable), TensorBoard when
tensorboardX is importable (copy of ``multimodalfilter_tpu/experiments/
logging.py``)."""

from __future__ import annotations

import json
import os
import time
from contextlib import contextmanager
from typing import List, Optional


class MetricLogger:
    def __init__(self, log_dir: str, experiment_name: str):
        self.log_dir = os.path.join(log_dir, experiment_name)
        os.makedirs(self.log_dir, exist_ok=True)
        self._jsonl_path = os.path.join(self.log_dir, "metrics.jsonl")
        self._scopes: List[str] = []
        self._tb = None
        try:
            from tensorboardX import SummaryWriter
        except ImportError:
            pass
        else:
            self._tb = SummaryWriter(self.log_dir)

    @contextmanager
    def log_scope(self, scope: str):
        self._scopes.append(scope)
        try:
            yield
        finally:
            self._scopes.pop()

    def _full_name(self, name: str) -> str:
        return "/".join(self._scopes + [name])

    def log_scalar(self, name: str, value: float, step: Optional[int] = None):
        full = self._full_name(name)
        record = {"name": full, "value": float(value), "step": step, "time": time.time()}
        with open(self._jsonl_path, "a") as f:
            f.write(json.dumps(record) + "\n")
        if self._tb is not None:
            self._tb.add_scalar(full, float(value), global_step=step)

    def flush(self):
        if self._tb is not None:
            self._tb.flush()
