"""Training loops and optimizers (port of ``multimodalfilter_tpu/train``)."""

from .loops import (
    train_dynamics_recurrent,
    train_dynamics_single_step,
    train_e2e,
    train_pf_measurement,
    train_virtual_sensor,
)
from .optim import get_named_optimizer, make_optimizer, zero_frozen_grads

__all__ = [
    "get_named_optimizer",
    "make_optimizer",
    "train_dynamics_recurrent",
    "train_dynamics_single_step",
    "train_e2e",
    "train_pf_measurement",
    "train_virtual_sensor",
    "zero_frozen_grads",
]
