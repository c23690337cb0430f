from . import _defs
from .models import (
    DoorCrossmodalParticleFilter,
    DoorCrossmodalParticleFilterSeq5,
    DoorCrossmodalWeightModel,
    DoorDynamicsModel,
    DoorDynamicsModelBrent,
    DoorLSTMFilter,
    DoorMeasurementModel,
    DoorParticleFilter,
    DoorUnimodalParticleFilter,
)

__all__ = [
    "DoorCrossmodalParticleFilter",
    "DoorCrossmodalParticleFilterSeq5",
    "DoorCrossmodalWeightModel",
    "DoorDynamicsModel",
    "DoorDynamicsModelBrent",
    "DoorLSTMFilter",
    "DoorMeasurementModel",
    "DoorParticleFilter",
    "DoorUnimodalParticleFilter",
    "_defs",
]
