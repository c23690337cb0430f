"""Push-task filter-def builders, state_dim 2, control_dim 7 (port of
``crossmodal/push_models/_defs.py``).

Against the door task:
  - process noise Q_tril = diag(sqrt(.02, .02)), one dynamics variant (the
    push PFs use it; there is no Brent variant);
  - the image encoder: the flatten variant in the PF measurement models, the
    spanning-average-pool variant in the virtual sensors (and the LSTM);
  - the PF gate has 1 fusion resblock (the door's has 3).
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

STATE_DIM = 2
CONTROL_DIM = 7
ALL_MODALITIES = ("image", "pos", "sensors")

Q_DIAG = tuple(math.sqrt(v) for v in (0.02, 0.02))


def _mods(modalities) -> Tuple[str, ...]:
    return tuple(m for m in ALL_MODALITIES if m in set(modalities))


def dynamics_def(units: int = 64, *, device=None) -> DynamicsDef:
    return DynamicsDef(
        DynamicsNet(state_dim=STATE_DIM, q_scale_tril_diag=Q_DIAG, units=units,
                    control_dim=CONTROL_DIM, device=device)
    )


def measurement_def(units: int = 64, modalities=ALL_MODALITIES, *,
                    device=None) -> MeasurementDef:
    return MeasurementDef(
        LogLikelihoodNet(STATE_DIM, _mods(modalities), units, spanning_avg_pool=False,
                         device=device)
    )


def virtual_sensor_def(units: int = 64, modalities=ALL_MODALITIES,
                       add_R_noise: float = 1e-6,
                       noise_R_tril: Optional[Tuple[float, ...]] = None, *,
                       device=None) -> VirtualSensorDef:
    return VirtualSensorDef(
        VirtualSensorNet(STATE_DIM, _mods(modalities), units, add_R_noise=add_R_noise,
                         spanning_avg_pool=True, noise_R_tril_diag=noise_R_tril,
                         device=device)
    )


def kf_weight_def(units: int = 64, state_dim: int = STATE_DIM, *,
                  device=None) -> KFWeightDef:
    return KFWeightDef(
        KFWeightNet(state_dim=state_dim, modality_count=2, units=units, device=device)
    )


def pf_weight_def(know_image_blackout: bool = False, units: int = 64, *,
                  device=None) -> PFWeightDef:
    return PFWeightDef(
        PFWeightNet(modality_count=2, units=units, num_fusion_resblocks=1,
                    device=device),
        know_image_blackout=know_image_blackout,
    )
