"""Push-task encoder factories and dimensions (port of
``crossmodal/push_models/layers.py``), with the spanning-average-pool image
variant. As for the door factories, each builds the port's encoder whose
state-dict keys are the flax encoder's param names."""

from ...models import ImageEncoder, MLPEncoder

state_dim = 2
control_dim = 7
obs_pos_dim = 3
obs_sensors_dim = 7


def state_layers(units: int, *, device=None) -> MLPEncoder:
    return MLPEncoder(state_dim, units, device=device)


def control_layers(units: int, *, device=None) -> MLPEncoder:
    return MLPEncoder(control_dim, units, device=device)


def observation_image_layers(units: int, spanning_avg_pool: bool = False, *,
                             device=None) -> ImageEncoder:
    return ImageEncoder(units, spanning_avg_pool, device=device)


def observation_pos_layers(units: int, *, device=None) -> MLPEncoder:
    return MLPEncoder(obs_pos_dim, units, device=device)


def observation_sensors_layers(units: int, *, device=None) -> MLPEncoder:
    return MLPEncoder(obs_sensors_dim, units, device=device)
