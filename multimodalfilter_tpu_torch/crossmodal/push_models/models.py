"""The ten push-task filters (port of ``crossmodal/push_models/models.py``):
the particle filters, the Kalman filters and the LSTM baseline at state
dimension 2. Each is a ``StatefulFilter`` over a filter def, runs on
``device`` (default ``cuda``) and registers itself as a ``--model-type``
choice by subclassing ``PushTask.Filter``.

The JAX package's two repairs of latent reference bugs are kept:
``PushMeasurementCrossmodalKalmanFilter`` gets a ``PushDynamicsModel``
instance (the reference passes the class), and
``PushMeasurementUnimodalKalmanFilter``'s fusion is at state dimension 2 (the
reference omits it; the port's fusion def reads it from its sensors).
"""

from __future__ import annotations

from ..._device import Device, resolve_device
from ...filtering import (
    CrossmodalKFDef,
    CrossmodalPFMeasurementDef,
    CrossmodalVirtualSensorDef,
    LSTMFilterDef,
    ParticleFilterDef,
    UnimodalKFDef,
    UnimodalVirtualSensorDef,
    VirtualSensorEKFDef,
)
from ...filtering.wrappers import StatefulFilter
from ...models import LSTMFilterNet
from ..tasks import PushTask
from . import _defs

# Factory aliases with the reference's class names (constructible components).
PushDynamicsModel = _defs.dynamics_def
PushMeasurementModel = _defs.measurement_def
PushVirtualSensorModel = _defs.virtual_sensor_def
PushCrossmodalKalmanFilterWeightModel = _defs.kf_weight_def
PushCrossmodalWeightModel = _defs.pf_weight_def


def _pf_def(measurement_model, device) -> ParticleFilterDef:
    return ParticleFilterDef(
        dynamics_model=PushDynamicsModel(device=device),
        measurement_model=measurement_model,
        state_dim=_defs.STATE_DIM,
    )


def _two_modality_models(device):
    return (
        PushMeasurementModel(modalities={"image"}, device=device),
        PushMeasurementModel(modalities={"pos", "sensors"}, device=device),
    )


class PushParticleFilter(StatefulFilter, PushTask.Filter):
    """Plain PF: one measurement model over all modalities
    (30 particles train / 300 eval)."""

    def __init__(self, *, device: Device = None, seed: int = 0):
        device = resolve_device(device)
        super().__init__(_pf_def(PushMeasurementModel(device=device), device),
                         device=device, seed=seed)


class PushCrossmodalParticleFilter(StatefulFilter, PushTask.Filter):
    """PF over image-MM + pos/sensors-MM with a learned log-weight gate."""

    def __init__(self, know_image_blackout: bool = False, *,
                 device: Device = None, seed: int = 0):
        device = resolve_device(device)
        super().__init__(
            _pf_def(
                CrossmodalPFMeasurementDef(
                    measurement_models=_two_modality_models(device),
                    crossmodal_weight_model=PushCrossmodalWeightModel(
                        know_image_blackout=know_image_blackout, device=device
                    ),
                ),
                device,
            ),
            device=device, seed=seed,
        )


class PushCrossmodalParticleFilterSeq5(PushCrossmodalParticleFilter, PushTask.Filter):
    """Blackout-aware crossmodal PF."""

    def __init__(self, *, device: Device = None, seed: int = 0):
        super().__init__(know_image_blackout=True, device=device, seed=seed)


class PushUnimodalParticleFilter(StatefulFilter, PushTask.Filter):
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


def _ekf_def(virtual_sensor_model, device, dynamics_model=None) -> VirtualSensorEKFDef:
    return VirtualSensorEKFDef(
        dynamics_model=(dynamics_model if dynamics_model is not None
                        else PushDynamicsModel(device=device)),
        virtual_sensor_model=virtual_sensor_model,
        state_dim=_defs.STATE_DIM,
    )


def _two_virtual_sensors(device):
    return (
        PushVirtualSensorModel(modalities={"image"}, device=device),
        PushVirtualSensorModel(modalities={"pos", "sensors"}, device=device),
    )


def _two_child_ekfs(device):
    return tuple(_ekf_def(vs, device) for vs in _two_virtual_sensors(device))


class PushKalmanFilter(StatefulFilter, PushTask.Filter):
    """Virtual-sensor EKF over all modalities. Given components must be
    built on the model's device."""

    def __init__(self, dynamics_model=None, virtual_sensor_model=None, *,
                 device: Device = None, seed: int = 0):
        device = resolve_device(device)
        if dynamics_model is None and virtual_sensor_model is None:
            dynamics_model = PushDynamicsModel(device=device)
            virtual_sensor_model = PushVirtualSensorModel(device=device)
        super().__init__(_ekf_def(virtual_sensor_model, device, dynamics_model),
                         device=device, seed=seed)


class PushCrossmodalKalmanFilter(StatefulFilter, PushTask.Filter):
    """Two child EKFs (image; pos+sensors) whose posteriors a learned
    per-state-dim gate mixes."""

    def __init__(self, know_image_blackout: bool = False, *,
                 device: Device = None, seed: int = 0):
        device = resolve_device(device)
        super().__init__(
            CrossmodalKFDef(
                filter_models=_two_child_ekfs(device),
                crossmodal_weight_model=PushCrossmodalKalmanFilterWeightModel(
                    state_dim=_defs.STATE_DIM, device=device),
                state_dim=_defs.STATE_DIM,
                know_image_blackout=know_image_blackout,
            ),
            device=device, seed=seed,
        )


class PushMeasurementCrossmodalKalmanFilter(StatefulFilter, PushTask.Filter):
    """One EKF over a gated fusion of two virtual sensors."""

    def __init__(self, *, device: Device = None, seed: int = 0):
        device = resolve_device(device)
        super().__init__(
            _ekf_def(
                CrossmodalVirtualSensorDef(
                    virtual_sensor_model=_two_virtual_sensors(device),
                    crossmodal_weight_model=PushCrossmodalKalmanFilterWeightModel(
                        state_dim=_defs.STATE_DIM, device=device),
                ),
                device,
            ),
            device=device, seed=seed,
        )


class PushUnimodalKalmanFilter(StatefulFilter, PushTask.Filter):
    """Two independent per-modality EKFs fused by precision weighting."""

    def __init__(self, *, device: Device = None, seed: int = 0):
        device = resolve_device(device)
        super().__init__(
            UnimodalKFDef(filter_models=_two_child_ekfs(device), state_dim=_defs.STATE_DIM),
            device=device, seed=seed,
        )


class PushMeasurementUnimodalKalmanFilter(StatefulFilter, PushTask.Filter):
    """One EKF over a precision-weighted fusion of two virtual sensors."""

    def __init__(self, *, device: Device = None, seed: int = 0):
        device = resolve_device(device)
        super().__init__(
            _ekf_def(UnimodalVirtualSensorDef(virtual_sensor_model=_two_virtual_sensors(
                device)), device),
            device=device, seed=seed,
        )


class PushLSTMFilter(StatefulFilter, PushTask.Filter):
    """LSTM baseline with the spanning-average-pool image encoder: the
    encoders of every modality, two LSTM cells of hidden size 512, a head to
    the state."""

    def __init__(self, units: int = 64, *, device: Device = None, seed: int = 0):
        device = resolve_device(device)
        super().__init__(
            LSTMFilterDef(
                net=LSTMFilterNet(state_dim=_defs.STATE_DIM, units=units,
                                  spanning_avg_pool=True, device=device),
                state_dim=_defs.STATE_DIM,
            ),
            device=device, seed=seed,
        )
