"""Trajectory datasets, the dataset cache and synthetic stand-ins (port of
``multimodalfilter_tpu/data``)."""

from .cache import cached_file, cached_trajectories, get_cache_path, set_cache_path
from .datasets import (
    ParticleFilterMeasurementDataset,
    SingleStepDataset,
    SubsequenceDataset,
)
from .trajectories_file import TrajectoriesFile

__all__ = [
    "ParticleFilterMeasurementDataset",
    "SingleStepDataset",
    "SubsequenceDataset",
    "TrajectoriesFile",
    "cached_file",
    "cached_trajectories",
    "get_cache_path",
    "set_cache_path",
]
