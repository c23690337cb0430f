from .encoders import ImageEncoder, MLPEncoder
from .resblocks import Conv2dResblock, LinearResblock
from .task_nets import (
    MODALITY_ORDER,
    DynamicsNet,
    KFWeightNet,
    LogLikelihoodNet,
    LSTMFilterNet,
    OptimizedLSTMCell,
    PFWeightNet,
    VirtualSensorNet,
)

__all__ = [
    "Conv2dResblock",
    "DynamicsNet",
    "ImageEncoder",
    "KFWeightNet",
    "LinearResblock",
    "LogLikelihoodNet",
    "LSTMFilterNet",
    "MLPEncoder",
    "MODALITY_ORDER",
    "OptimizedLSTMCell",
    "PFWeightNet",
    "VirtualSensorNet",
]
