"""Training helpers (port of ``crossmodal/train_helpers.py``): module-global
configuration (``configure(buddy=..., trajectories=...)``) and the
curriculum primitives of the door and push filters, with the JAX package's
signatures and defaults."""

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
mesh = None
pipeline_mesh = None
pipeline_microbatches = None  # None: the largest divisor of the per-shard batch up to 8


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
    device). ``mesh`` (a "data" axis) trains e2e BPTT data-parallel;
    ``pipeline_mesh`` (a "pipe" axis, with "data" and "particle" axes where
    present) runs it through the temporal pipeline instead
    (``train.loops.train_e2e``). The two are exclusive; the other
    curriculum primitives run on each rank alike, as in the JAX package."""
    from ..parallel.mesh import axis_names

    if mesh is not None and pipeline_mesh is not None:
        raise ValueError("mesh (data-parallel) and pipeline_mesh (pipelined) are exclusive")
    if mesh is not None and "data" not in axis_names(mesh):
        raise ValueError(f"a data-parallel mesh needs a 'data' axis, not {axis_names(mesh)}")
    if pipeline_mesh is not None and "pipe" not in axis_names(pipeline_mesh):
        raise ValueError("a pipeline mesh needs a 'pipe' axis, not "
                         f"{axis_names(pipeline_mesh)}")
    globals()["buddy"] = buddy
    globals()["filter_model"] = buddy.model
    globals()["trajectories"] = trajectories
    globals()["num_workers"] = num_workers
    globals()["mesh"] = mesh
    globals()["pipeline_mesh"] = pipeline_mesh
    globals()["pipeline_microbatches"] = pipeline_microbatches


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


def train_virtual_sensor(*, epochs, batch_size=32, model=None,
                         optimizer_name="train_virtual_sensor"):
    model = model if model is not None else filter_model
    return _train.train_virtual_sensor(
        buddy, model, SingleStepDataset(trajectories=trajectories),
        epochs=epochs, batch_size=batch_size, optimizer_name=optimizer_name,
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
        optimizer_name=optimizer_name, mesh=mesh, pipeline_mesh=pipeline_mesh,
        pipeline_microbatches=pipeline_microbatches,
    )
