"""Experiment manager, the training subset (port of
``multimodalfilter_tpu/experiments/buddy.py``): the attached model, the
optimizer-step counter, a clearable dict of named optimizers (the curricula
clear it between phases, train_door.py:159) and scalar logging.
Checkpoints and metadata are not ported yet.
"""

from __future__ import annotations

from typing import Dict

import torch

from .logging import MetricLogger

DEFAULT_LOG_DIR = "logs"


class Buddy:
    def __init__(self, experiment_name: str, model=None, *,
                 log_dir: str = DEFAULT_LOG_DIR):
        self.experiment_name = experiment_name
        self._model = None
        # Named optimizers, created lazily by the train loops. A plain dict:
        # the JAX package's subclass also drops checkpoint-restored optimizer
        # states on clear(), and there are no checkpoints here yet.
        self._optimizer_dict: Dict[str, torch.optim.Optimizer] = {}
        self._steps = 0
        self._logger = MetricLogger(log_dir, experiment_name)
        if model is not None:
            self.attach_model(model)

    # -- model ---------------------------------------------------------------
    def attach_model(self, model) -> None:
        self._model = model

    @property
    def model(self):
        if self._model is None:
            raise RuntimeError("No model attached")
        return self._model

    # -- optimizer steps counter ----------------------------------------------
    @property
    def optimizer_steps(self) -> int:
        return self._steps

    def increment_steps(self, n: int = 1) -> None:
        self._steps += n

    # -- logging ---------------------------------------------------------------
    def log_scope(self, scope: str):
        return self._logger.log_scope(scope)

    def log_scalar(self, name: str, value: float) -> None:
        self._logger.log_scalar(name, value, step=self._steps)
