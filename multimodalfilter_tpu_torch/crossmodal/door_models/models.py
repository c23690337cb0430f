"""Door-task particle filters (port of the PF classes of
``crossmodal/door_models/models.py``). Each is a ``StatefulFilter`` over a
``ParticleFilterDef``, runs on ``device`` (default ``cuda``) and registers
itself as a ``--model-type`` choice by subclassing ``DoorTask.Filter``."""

from __future__ import annotations

from ..._device import Device, resolve_device
from ...filtering import CrossmodalPFMeasurementDef, ParticleFilterDef
from ...filtering.wrappers import StatefulFilter
from ..tasks import DoorTask
from . import _defs


def _pf_def(measurement_model, device) -> ParticleFilterDef:
    return ParticleFilterDef(
        dynamics_model=_defs.dynamics_def(brent=True, device=device),
        measurement_model=measurement_model,
        state_dim=_defs.STATE_DIM,
    )


def _two_modality_models(device):
    return (
        _defs.measurement_def(modalities={"image"}, device=device),
        _defs.measurement_def(modalities={"pos", "sensors"}, device=device),
    )


class DoorParticleFilter(StatefulFilter, DoorTask.Filter):
    """Plain PF: one measurement model over all modalities
    (30 particles train / 300 eval)."""

    def __init__(self, *, device: Device = None, seed: int = 0):
        device = resolve_device(device)
        super().__init__(_pf_def(_defs.measurement_def(device=device), device),
                         device=device, seed=seed)


class DoorCrossmodalParticleFilter(StatefulFilter, DoorTask.Filter):
    """PF over image-MM + pos/sensors-MM with a learned log-weight gate."""

    def __init__(self, know_image_blackout: bool = False, *,
                 device: Device = None, seed: int = 0):
        device = resolve_device(device)
        super().__init__(
            _pf_def(
                CrossmodalPFMeasurementDef(
                    measurement_models=_two_modality_models(device),
                    crossmodal_weight_model=_defs.pf_weight_def(
                        know_image_blackout=know_image_blackout, device=device
                    ),
                ),
                device,
            ),
            device=device, seed=seed,
        )


class DoorCrossmodalParticleFilterSeq5(DoorCrossmodalParticleFilter, DoorTask.Filter):
    """Blackout-aware crossmodal PF, for the seq5 dataset."""

    def __init__(self, *, device: Device = None, seed: int = 0):
        super().__init__(know_image_blackout=True, device=device, seed=seed)


class DoorUnimodalParticleFilter(StatefulFilter, DoorTask.Filter):
    """Crossmodal PF measurement fusion with no gate (equal weights)."""

    def __init__(self, *, device: Device = None, seed: int = 0):
        device = resolve_device(device)
        super().__init__(
            _pf_def(
                CrossmodalPFMeasurementDef(
                    measurement_models=_two_modality_models(device),
                    crossmodal_weight_model=None,
                ),
                device,
            ),
            device=device, seed=seed,
        )
