"""Training helpers (port of ``crossmodal/train_helpers.py``): module-global
configuration (``configure(buddy=..., trajectories=...)``) and the
curriculum primitives of the crossmodal particle filter, with the JAX
package's signatures and defaults."""

from __future__ import annotations

from typing import List

import numpy as np

from .. import train as _train
from ..data import (
    ParticleFilterMeasurementDataset,
    SingleStepDataset,
    SubsequenceDataset,
)
from ..experiments import Buddy
from ..types import Trajectory

# Module globals, set by configure().
buddy: Buddy
filter_model = None
trajectories: List[Trajectory]
num_workers: int = 0


def configure(
    *,
    buddy: Buddy,
    trajectories: List[Trajectory],
    num_workers: int = 0,
    mesh=None,
    pipeline_mesh=None,
    pipeline_microbatches=None,
):
    """Configure global settings for the training helpers. ``num_workers``
    is accepted for CLI compatibility and unused (the data lives on the
    device); ``mesh`` and ``pipeline_mesh`` are not ported yet."""
    del pipeline_microbatches  # read only with a pipeline_mesh
    if mesh is not None or pipeline_mesh is not None:
        raise NotImplementedError(
            "data-parallel and pipelined training are not ported yet (ROADMAP A13)"
        )
    globals()["buddy"] = buddy
    globals()["filter_model"] = buddy.model
    globals()["trajectories"] = trajectories
    globals()["num_workers"] = num_workers


def _check_mse(loss_function):
    if loss_function != "mse":
        raise ValueError("Only the reference's MSE loss is supported")


def train_pf_dynamics_single_step(*, epochs, batch_size=32, model=None,
                                  loss_function="mse"):
    _check_mse(loss_function)
    model = model if model is not None else filter_model
    return _train.train_dynamics_single_step(
        buddy, model, SingleStepDataset(trajectories=trajectories),
        epochs=epochs, batch_size=batch_size,
    )


def train_pf_dynamics_recurrent(*, subsequence_length, epochs, batch_size=32,
                                model=None, loss_function="mse"):
    _check_mse(loss_function)
    model = model if model is not None else filter_model
    dataset = SubsequenceDataset(trajectories=trajectories,
                                 subsequence_length=subsequence_length)
    return _train.train_dynamics_recurrent(
        buddy, model, dataset, epochs=epochs, batch_size=batch_size
    )


def train_pf_measurement(*, epochs, batch_size, cov_scale=0.1):
    dataset = ParticleFilterMeasurementDataset(
        trajectories=trajectories,
        covariance=np.identity(filter_model.state_dim) * cov_scale,
        samples_per_pair=10,
    )
    return _train.train_pf_measurement(
        buddy, filter_model, dataset, epochs=epochs, batch_size=batch_size
    )


def train_e2e(*, subsequence_length, epochs, batch_size=32, initial_cov_scale=0.1,
              measurement_initialize=False, model=None,
              optimizer_name="train_filter_recurrent"):
    model = model if model is not None else filter_model
    dataset = SubsequenceDataset(trajectories=trajectories,
                                 subsequence_length=subsequence_length)
    return _train.train_e2e(
        buddy, model, dataset, epochs=epochs, batch_size=batch_size,
        initial_cov_scale=initial_cov_scale,
        measurement_initialize=measurement_initialize,
        optimizer_name=optimizer_name,
    )
