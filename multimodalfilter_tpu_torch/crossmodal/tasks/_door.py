"""Door-opening task: dataset definition and model registry (port of
``crossmodal/tasks/_door.py``).

  - dataset files and train/eval splits;
  - state = (door theta, hinge x, hinge y) from object-state cols 1, 3, 4;
  - observations: gripper_pos (T, 3); gripper_sensors = force, torque,
    contact (T, 7); image 64x64 -> [::2, ::2] -> 32x32;
  - image masking: zero / sequential-rate / random-blackout;
  - controls = prev EEF pos, delta EEF pos, contact (T, 7);
  - hardcoded z-score normalization constants, which the eval's
    de-normalization reuses.

The host steps run through ``native`` (the JAX package's numpy
expressions, the same float32 operations in the same order), so the loaded
arrays are bitwise the JAX loader's.
"""

from __future__ import annotations

import argparse
import sys
from typing import Any, Dict, List

import numpy as np

from ... import native
from ...data import cached_trajectories
from ...types import Trajectory
from ._task import Task

dataset_urls = {
    "panda_door_pull_10.hdf5": "https://drive.google.com/open?id=1sO3avSEtegDcgISHdALDMW59b-knRRvf",
    "panda_door_pull_100.hdf5": "https://drive.google.com/open?id=1HCDnimAhCDP8OGZimWMRlq8MkrRzOcgf",
    "panda_door_pull_300.hdf5": "https://drive.google.com/open?id=1YSvBR7-JAnH88HRVFAZwiJNY_osLm8aH",
    "panda_door_pull_500.hdf5": "https://drive.google.com/open?id=1dE_jw3-JyX2JagFnCwrfjex4-mwvlEC-",
    "panda_door_push_10.hdf5": "https://drive.google.com/open?id=1nZsQE6FtQwyLkfUQL4CPEc01LjYa_QFy",
    "panda_door_push_100.hdf5": "https://drive.google.com/open?id=1JEDGZWpWE-Z9kuCvRBJh_Auhc-2V0UpN",
    "panda_door_push_300.hdf5": "https://drive.google.com/open?id=18AnusvGEWYA52MHHciq5rHwHJmlx-Ldm",
    "panda_door_push_500.hdf5": "https://drive.google.com/open?id=1TgMp0RIjzxdw6zrRMzGC5tutxYqQ_Tze",
}

# Z-score normalization constants (reference _door.py:224-296). The state
# stddevs double as the eval de-normalization factors (eval_helpers.py:167).
NORMALIZATION = {
    "gripper_pos_mean": [0.37334135, -0.10821614, 1.5769919],
    "gripper_pos_std": [0.13496609, 0.14862472, 0.04533212],
    "gripper_sensors_mean": [
        11.064128, -1.7103539, 28.303621, 0.06923943, 1.661722, -0.14174654,
        0.63155425,
    ],
    "gripper_sensors_std": [
        36.36674, 18.355747, 58.651367, 1.8596123, 4.574878, 0.64844555,
        0.48232532,
    ],
    "states_mean": [0.64900873, -0.00079839, -0.00069189],
    "states_std": [0.39479038, 0.05650279, 0.0565098],
    "controls_mean": [
        3.7333974e-01, -1.0831217e-01, 1.5769361e00, 3.1821314e-06,
        9.5862495e-05, 4.8311016e-05, 6.3155425e-01,
    ],
    "controls_std": [
        0.134951, 0.14904341, 0.04531819, 0.00323106, 0.00411722, 0.00165688,
        0.48232532,
    ],
}


class DoorTask(Task):
    """Dataset definition and model registry for the door manipulation task."""

    @classmethod
    def add_dataset_arguments(cls, parser: argparse.ArgumentParser) -> None:
        parser.add_argument("--no_vision", action="store_true")
        parser.add_argument("--no_proprioception", action="store_true")
        parser.add_argument("--no_haptics", action="store_true")
        parser.add_argument("--image_blackout_ratio", type=float, default=0.0)
        parser.add_argument("--sequential_image_rate", type=int, default=1)

    @classmethod
    def get_dataset_args(cls, args: argparse.Namespace) -> Dict[str, Any]:
        return {
            "use_vision": not args.no_vision,
            "use_proprioception": not args.no_proprioception,
            "use_haptics": not args.no_haptics,
            "image_blackout_ratio": args.image_blackout_ratio,
            "sequential_image_rate": args.sequential_image_rate,
        }

    @classmethod
    def get_train_trajectories(cls, **dataset_args) -> List[Trajectory]:
        return _load_trajectories(
            "panda_door_pull_100.hdf5", "panda_door_push_100.hdf5", **dataset_args
        )

    @classmethod
    def get_eval_trajectories(cls, **dataset_args) -> List[Trajectory]:
        return _load_trajectories(
            "panda_door_pull_10.hdf5", "panda_door_push_10.hdf5", **dataset_args
        )


def make_image_mask(
    timesteps: int,
    *,
    use_vision: bool,
    image_blackout_ratio: float,
    sequential_image_rate: int,
    rng: np.random.Generator,
) -> np.ndarray:
    """Sensor-fault-injection mask over image frames (reference
    _door.py:181-197): all-zero when vision is off; 1-in-N frames under a
    sequential rate; iid Bernoulli keep-mask under a blackout ratio."""
    if not use_vision:
        return np.zeros((timesteps, 1, 1), dtype=np.float32)
    if image_blackout_ratio == 0.0:
        mask = np.zeros((timesteps, 1, 1), dtype=np.float32)
        mask[::sequential_image_rate, 0, 0] = 1.0
        return mask
    keep = rng.uniform(size=(timesteps,)) > image_blackout_ratio
    return keep.astype(np.float32).reshape(timesteps, 1, 1)


def make_controls(eef_positions: np.ndarray, contact: np.ndarray) -> np.ndarray:
    """controls = prev EEF pos ⊕ ΔEEF pos ⊕ contact (reference _door.py:206-222)."""
    shifted = np.roll(eef_positions, shift=1, axis=0)
    shifted[0] = eef_positions[0]
    return np.concatenate(
        [shifted, eef_positions - shifted, contact[:, np.newaxis]], axis=1
    ).astype(np.float32)


def _normalize(array: np.ndarray, mean_key: str, std_key: str) -> np.ndarray:
    mean = np.array(NORMALIZATION[mean_key], dtype=np.float32)
    std = np.array(NORMALIZATION[std_key], dtype=np.float32)
    return native.normalize(array, mean, std)


def _check_shape(name: str, key: str, shape, expected) -> None:
    if tuple(shape) != expected:
        raise ValueError(f"{name}: {key} has shape {tuple(shape)}, expected {expected}")


def _load_trajectories(
    *input_files,
    use_vision: bool = True,
    use_proprioception: bool = True,
    use_haptics: bool = True,
    vision_interval: int = 10,
    image_blackout_ratio: float = 0.0,
    sequential_image_rate: int = 1,
    start_timestep: int = 0,
    seed: int = None,
) -> List[Trajectory]:
    """Load + preprocess trajectories. Inputs are filenames (members of
    ``dataset_urls``) or (filename, max_count) tuples."""
    if not 1 > image_blackout_ratio >= 0:
        raise ValueError(f"image_blackout_ratio {image_blackout_ratio} not in [0, 1)")
    if image_blackout_ratio != 0 and sequential_image_rate != 1:
        raise ValueError("image_blackout_ratio and sequential_image_rate exclude each other")
    rng = np.random.default_rng(seed)

    trajectories: List[Trajectory] = []
    for entry in input_files:
        name, max_count = (entry, sys.maxsize) if isinstance(entry, str) else entry
        raw_list = cached_trajectories(name, dataset_urls[name])

        for traj_index, raw in enumerate(raw_list):
            if traj_index >= max_count:
                break
            timesteps = len(raw["object-state"])

            # object-state = (contact, theta, theta_vel, hinge_x, hinge_y);
            # state = (theta, hinge_x, hinge_y).
            states = np.stack(
                [
                    raw["object-state"][:, 1],
                    raw["object-state"][:, 3],
                    raw["object-state"][:, 4],
                ],
                axis=1,
            ).astype(np.float32)

            gripper_pos = np.asarray(raw["eef_pos"], dtype=np.float32)
            _check_shape(name, "eef_pos", gripper_pos.shape, (timesteps, 3))
            gripper_sensors = np.concatenate(
                [
                    raw["ee-force-obs"],
                    raw["ee-torque-obs"],
                    np.asarray(raw["contact-obs"]).reshape(timesteps, 1),
                ],
                axis=1,
            ).astype(np.float32)
            _check_shape(name, "gripper_sensors", gripper_sensors.shape, (timesteps, 7))

            if not use_proprioception:
                gripper_pos[:] = 0
            if not use_haptics:
                gripper_sensors[:] = 0

            # 64x64 -> 32x32 via stride-2 subsampling, then per-timestep
            # blackout masking.
            image = native.subsample2(raw["image"])
            _check_shape(name, "image", image.shape, (timesteps, 32, 32))
            mask = make_image_mask(
                timesteps,
                use_vision=use_vision,
                image_blackout_ratio=image_blackout_ratio,
                sequential_image_rate=sequential_image_rate,
                rng=rng,
            )
            image = native.apply_mask(image, mask)

            # NOTE: the reference's observations["gripper_pos"] aliases the
            # raw eef_pos array, so --no_proprioception zeroes the controls
            # source too (_door.py:155,169-170,211) — controls are built from
            # the (possibly zeroed) un-normalized positions.
            contact = np.asarray(raw["contact-obs"], dtype=np.float32)
            controls = make_controls(gripper_pos, contact)

            observations = {
                "gripper_pos": _normalize(gripper_pos, "gripper_pos_mean", "gripper_pos_std"),
                "gripper_sensors": _normalize(
                    gripper_sensors, "gripper_sensors_mean", "gripper_sensors_std"
                ),
                "image": image,
            }
            states = _normalize(states, "states_mean", "states_std")
            controls = _normalize(controls, "controls_mean", "controls_std")

            trajectories.append(
                Trajectory(
                    states[start_timestep:],
                    {k: v[start_timestep:] for k, v in observations.items()},
                    controls[start_timestep:],
                )
            )

            raw_list[traj_index] = None  # release memory as we go
    return trajectories
