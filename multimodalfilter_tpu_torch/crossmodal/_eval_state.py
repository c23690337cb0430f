"""Shared configured state of the eval modules (port of
``crossmodal/_eval_state.py``).

``eval_helpers.configure`` writes ``buddy``, ``filter_model``, ``task``,
``dataset_args`` and the data-parallel ``mesh`` here, and the batching,
throughput and metric modules read them.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

buddy = None
filter_model = None
task = None
dataset_args: Dict = {}
mesh = None

# Eval batch and init-tensor cache, cleared by configure().
batch_cache: Dict = {}

# Stream of per-repeat blackout seeds (device-side re-masking).
rng = np.random.default_rng(0)


def set_state(*, buddy, task, dataset_args: Dict, mesh=None) -> None:
    g = globals()
    g["buddy"] = buddy
    g["filter_model"] = buddy.model
    g["task"] = task
    g["dataset_args"] = dataset_args
    g["mesh"] = mesh
    batch_cache.clear()
