"""Trajectory datasets (port of ``multimodalfilter_tpu/data``)."""

from .datasets import (
    ParticleFilterMeasurementDataset,
    SingleStepDataset,
    SubsequenceDataset,
)

__all__ = [
    "ParticleFilterMeasurementDataset",
    "SingleStepDataset",
    "SubsequenceDataset",
]
