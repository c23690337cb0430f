"""Metric logging: JSONL always (machine-readable), TensorBoard when
tensorboardX is importable (copy of ``multimodalfilter_tpu/experiments/
logging.py``, with a logger that writes nothing for the other ranks of a
multi-device run)."""

from __future__ import annotations

import json
import os
import time
from contextlib import contextmanager
from typing import List, Optional


class MetricLogger:
    """Writes nothing where `write` is False (the ranks other than 0 of a
    multi-device run)."""

    def __init__(self, log_dir: str, experiment_name: str, write: bool = True):
        self.log_dir = os.path.join(log_dir, experiment_name)
        self._write = write
        self._jsonl_path = os.path.join(self.log_dir, "metrics.jsonl")
        self._scopes: List[str] = []
        self._tb = None
        if not write:
            return
        os.makedirs(self.log_dir, exist_ok=True)
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
        if not self._write:
            return
        full = self._full_name(name)
        record = {"name": full, "value": float(value), "step": step, "time": time.time()}
        with open(self._jsonl_path, "a") as f:
            f.write(json.dumps(record) + "\n")
        if self._tb is not None:
            self._tb.add_scalar(full, float(value), global_step=step)

    def flush(self):
        if self._tb is not None:
            self._tb.flush()
