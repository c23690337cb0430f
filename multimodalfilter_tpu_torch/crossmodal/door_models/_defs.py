"""Door-task filter-def builders, state_dim 3, control_dim 7 (port of
``crossmodal/door_models/_defs.py``).

Process noise: DoorDynamicsModel Q_tril = diag(sqrt(.05, .01, .01));
DoorDynamicsModelBrent divides it by 8.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

from ...filtering import (
    DynamicsDef,
    KFWeightDef,
    MeasurementDef,
    PFWeightDef,
    VirtualSensorDef,
)
from ...models import DynamicsNet, KFWeightNet, LogLikelihoodNet, PFWeightNet, VirtualSensorNet

STATE_DIM = 3
CONTROL_DIM = 7
ALL_MODALITIES = ("image", "pos", "sensors")

Q_DIAG = tuple(math.sqrt(v) for v in (0.05, 0.01, 0.01))
Q_DIAG_BRENT = tuple(math.sqrt(v) / 8.0 for v in (0.05, 0.01, 0.01))


def _mods(modalities) -> Tuple[str, ...]:
    return tuple(m for m in ALL_MODALITIES if m in set(modalities))


def dynamics_def(units: int = 64, brent: bool = False, *, device=None) -> DynamicsDef:
    return DynamicsDef(
        DynamicsNet(
            state_dim=STATE_DIM,
            q_scale_tril_diag=Q_DIAG_BRENT if brent else Q_DIAG,
            units=units,
            control_dim=CONTROL_DIM,
            device=device,
        )
    )


def measurement_def(units: int = 64, modalities=ALL_MODALITIES, *,
                    device=None) -> MeasurementDef:
    return MeasurementDef(
        LogLikelihoodNet(STATE_DIM, _mods(modalities), units, device=device)
    )


def virtual_sensor_def(units: int = 64, modalities=ALL_MODALITIES,
                       add_R_noise: float = 1e-6,
                       noise_R_tril: Optional[Tuple[float, ...]] = None, *,
                       device=None) -> VirtualSensorDef:
    return VirtualSensorDef(
        VirtualSensorNet(STATE_DIM, _mods(modalities), units, add_R_noise=add_R_noise,
                         noise_R_tril_diag=noise_R_tril, device=device)
    )


def kf_weight_def(units: int = 64, state_dim: int = STATE_DIM, *,
                  device=None) -> KFWeightDef:
    return KFWeightDef(
        KFWeightNet(state_dim=state_dim, modality_count=2, units=units, device=device)
    )


def pf_weight_def(know_image_blackout: bool = False, units: int = 64, *,
                  device=None) -> PFWeightDef:
    # Door gate: 3 fusion resblocks.
    return PFWeightDef(
        PFWeightNet(modality_count=2, units=units, num_fusion_resblocks=3,
                    device=device),
        know_image_blackout=know_image_blackout,
    )
