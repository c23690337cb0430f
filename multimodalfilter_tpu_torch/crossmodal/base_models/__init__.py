"""Fusion abstractions under the reference's names (port of the repo's
``crossmodal/base_models/__init__.py``, API parity with the reference's
``crossmodal/base_models/__init__.py:1-11``); the implementations are the
port's ``filtering/fusion.py``."""

from ...filtering.fusion import (
    CrossmodalKFDef as CrossmodalKalmanFilter,
    CrossmodalPFMeasurementDef as CrossmodalParticleFilterMeasurementModel,
    CrossmodalVirtualSensorDef as CrossmodalVirtualSensorModel,
    KFWeightDef as CrossmodalKalmanFilterWeightModel,
    PFWeightDef as CrossmodalWeightModel,
    UnimodalKFDef as UnimodalKalmanFilter,
    UnimodalVirtualSensorDef as UnimodalVirtualSensorModel,
    weighted_average,
)

__all__ = [
    "CrossmodalKalmanFilter",
    "CrossmodalKalmanFilterWeightModel",
    "CrossmodalParticleFilterMeasurementModel",
    "CrossmodalVirtualSensorModel",
    "CrossmodalWeightModel",
    "UnimodalKalmanFilter",
    "UnimodalVirtualSensorModel",
    "weighted_average",
]
