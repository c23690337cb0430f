from .base import DynamicsDef, FilterDef, MeasurementDef
from .fusion import CrossmodalPFMeasurementDef, PFWeightDef, weighted_average
from .lstm import LSTMFilterDef
from .pf import ParticleFilterDef
from .wrappers import StatefulFilter

__all__ = [
    "CrossmodalPFMeasurementDef",
    "DynamicsDef",
    "FilterDef",
    "LSTMFilterDef",
    "MeasurementDef",
    "ParticleFilterDef",
    "PFWeightDef",
    "StatefulFilter",
    "weighted_average",
]
