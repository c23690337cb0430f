from .encoders import ImageEncoder, MLPEncoder
from .resblocks import Conv2dResblock, LinearResblock
from .task_nets import (
    MODALITY_ORDER,
    DynamicsNet,
    LogLikelihoodNet,
    LSTMFilterNet,
    OptimizedLSTMCell,
    PFWeightNet,
)

__all__ = [
    "Conv2dResblock",
    "DynamicsNet",
    "ImageEncoder",
    "LinearResblock",
    "LogLikelihoodNet",
    "LSTMFilterNet",
    "MLPEncoder",
    "MODALITY_ORDER",
    "OptimizedLSTMCell",
    "PFWeightNet",
]
