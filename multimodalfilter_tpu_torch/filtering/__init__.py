from .base import DynamicsDef, FilterDef, MeasurementDef, VirtualSensorDef
from .ekf import VirtualSensorEKFDef
from .fusion import (
    CrossmodalKFDef,
    CrossmodalPFMeasurementDef,
    CrossmodalVirtualSensorDef,
    KFWeightDef,
    PFWeightDef,
    UnimodalKFDef,
    UnimodalVirtualSensorDef,
    weighted_average,
)
from .lstm import LSTMFilterDef
from .pf import ParticleFilterDef
from .wrappers import StatefulFilter

__all__ = [
    "CrossmodalKFDef",
    "CrossmodalPFMeasurementDef",
    "CrossmodalVirtualSensorDef",
    "DynamicsDef",
    "FilterDef",
    "KFWeightDef",
    "LSTMFilterDef",
    "MeasurementDef",
    "ParticleFilterDef",
    "PFWeightDef",
    "StatefulFilter",
    "UnimodalKFDef",
    "UnimodalVirtualSensorDef",
    "VirtualSensorDef",
    "VirtualSensorEKFDef",
    "weighted_average",
]
