"""Planar-pushing task: dataset definition and model registry (port of
``crossmodal/tasks/_push.py``).

  - two data sources: MuJoCo ``gentle_push_*`` and real-robot ``kloss_*``;
    the ``kloss_dataset`` flag reroutes the keys;
  - state = object (x, y): Cylinder0_pos[:, :2] (MuJoCo) or pos columns 0
    and 2 (kloss);
  - observations: gripper_pos (T, 3); gripper_sensors = force, contact
    (T, 7; kloss fills columns 0-2 and 6); image (T, 32, 32), the kloss RGB
    frames grayscaled by their channel mean;
  - a normalization table per source; the eval split is gentle_push_10 or
    the first 50 trajectories of kloss_val.

As for the door loader, the normalisation and masking run through
``native``, the JAX package's numpy expressions, so the loaded arrays are
bitwise the JAX loader's.
"""

from __future__ import annotations

import argparse
import sys
from typing import Any, Dict, List

import numpy as np

from ... import native
from ...data import cached_trajectories
from ...types import Trajectory
from ._door import _check_shape, make_controls, make_image_mask
from ._task import Task

dataset_urls = {
    # MuJoCo
    "gentle_push_10.hdf5": "https://drive.google.com/file/d/1qmBCfsAGu8eew-CQFmV1svodl9VJa6fX/view?usp=sharing",
    "gentle_push_100.hdf5": "https://drive.google.com/file/d/1PmqQy5myNXSei56upMy3mXKu5Lk7Fr_g/view?usp=sharing",
    "gentle_push_300.hdf5": "https://drive.google.com/file/d/18dr1z0N__yFiP_DAKxy-Hs9Vy_AsaW6Q/view?usp=sharing",
    "gentle_push_1000.hdf5": "https://drive.google.com/file/d/1JTgmq1KPRK9HYi8BgvljKg5MPqT_N4cR/view?usp=sharing",
    # Real-robot data (kloss_dataset=True)
    "kloss_train0.hdf5": "https://drive.google.com/file/d/1nk4BO0rcVTKw22vYq6biewiwAFUPevM1/view?usp=sharing",
    "kloss_train1.hdf5": "https://drive.google.com/file/d/1gBWoB2PCrgYlLjuDJQm6BFAf_xwMqRxa/view?usp=sharing",
    "kloss_train2.hdf5": "https://drive.google.com/file/d/15W2zj52bSITxIRVRi7ajehAmz14RU33M/view?usp=sharing",
    "kloss_train3.hdf5": "https://drive.google.com/file/d/1WhRFu4SDlIYKnLYLyDdgOQYjP20JOTLE/view?usp=sharing",
    "kloss_train4.hdf5": "https://drive.google.com/file/d/1-ur_hzyBvd1_QCLTamaO8eWJ7rXii7y4/view?usp=sharing",
    "kloss_train5.hdf5": "https://drive.google.com/file/d/1ni8vEy4c1cmCKP2ZlWfXqLo7a4sdRFwe/view?usp=sharing",
    "kloss_val.hdf5": "https://drive.google.com/file/d/1-CRocf7I4mTLBp7Tjo7-D-QvkwcGZkNo/view?usp=sharing",
}

# Z-score normalization constants, keyed by data source (reference
# _push.py:262-399). The eval de-normalizes with the MuJoCo state stddevs
# for both sources, as the reference does.
NORMALIZATION = {
    "mujoco": {
        "gripper_pos_mean": [0.46806443, -0.0017836, 0.88028437],
        "gripper_pos_std": [0.02410769, 0.02341035, 0.04018243],
        "gripper_sensors_mean": [
            4.9182904e-01, 4.5039989e-02, -3.2791464e00, -3.3874984e-03,
            1.1552566e-02, -8.4817986e-04, 2.1303751e-01,
        ],
        "gripper_sensors_std": [
            1.6152629, 1.666905, 1.9186896, 0.14219016, 0.14232528,
            0.01675198, 0.40950698,
        ],
        "states_mean": [0.4970164, -0.00916641],
        "states_std": [0.0572766, 0.06118315],
        "controls_mean": [
            4.6594709e-01, -2.5247163e-03, 8.8094306e-01, 1.2939950e-04,
            -5.4364675e-05, -6.1112235e-04, 2.2041667e-01,
        ],
        "controls_std": [
            0.02239027, 0.02356066, 0.0405312, 0.00054858, 0.0005754,
            0.00046352, 0.41451886,
        ],
    },
    "kloss": {
        "gripper_pos_mean": [-0.00360131, 0.0, 0.00022349],
        "gripper_pos_std": [0.07005621, 1.0, 0.06883541],
        "gripper_sensors_mean": [
            3.04424347e-02, 1.61328610e-02, -2.47517393e-04, 0.0, 0.0, 0.0,
            6.25842857e-01,
        ],
        "gripper_sensors_std": [
            2.09539968, 2.0681382, 0.00373115, 1.0, 1.0, 1.0, 0.48390451,
        ],
        "states_mean": [-0.00279736, -0.00027878],
        "states_std": [0.06409658, 0.06649422],
        "controls_mean": [
            -3.55868486e-03, 0.0, 2.34369027e-04, -4.26185595e-05, 0.0,
            -1.08724583e-05, 6.25842857e-01,
        ],
        "controls_std": [
            0.0693582, 1.0, 0.06810329, 0.01176415, 1.0, 0.0115694,
            0.48390451,
        ],
    },
}


class PushTask(Task):
    """Dataset definition and model registry for the pushing task."""

    @classmethod
    def add_dataset_arguments(cls, parser: argparse.ArgumentParser) -> None:
        parser.add_argument("--no_vision", action="store_true")
        parser.add_argument("--no_proprioception", action="store_true")
        parser.add_argument("--no_haptics", action="store_true")
        parser.add_argument("--image_blackout_ratio", type=float, default=0.0)
        parser.add_argument("--sequential_image_rate", type=int, default=1)
        parser.add_argument("--kloss_dataset", action="store_true")

    @classmethod
    def get_dataset_args(cls, args: argparse.Namespace) -> Dict[str, Any]:
        return {
            "use_vision": not args.no_vision,
            "use_proprioception": not args.no_proprioception,
            "use_haptics": not args.no_haptics,
            "image_blackout_ratio": args.image_blackout_ratio,
            "sequential_image_rate": args.sequential_image_rate,
            "kloss_dataset": args.kloss_dataset,
        }

    @classmethod
    def get_train_trajectories(cls, **dataset_args) -> List[Trajectory]:
        if dataset_args.get("kloss_dataset", False):
            return _load_trajectories(
                *[f"kloss_train{i}.hdf5" for i in range(6)], **dataset_args
            )
        return _load_trajectories("gentle_push_1000.hdf5", **dataset_args)

    @classmethod
    def get_eval_trajectories(cls, **dataset_args) -> List[Trajectory]:
        if dataset_args.get("kloss_dataset", False):
            return _load_trajectories(("kloss_val.hdf5", 50), **dataset_args)
        return _load_trajectories("gentle_push_10.hdf5", **dataset_args)


def _load_trajectories(
    *input_files,
    use_vision: bool = True,
    use_proprioception: bool = True,
    use_haptics: bool = True,
    vision_interval: int = 10,
    image_blackout_ratio: float = 0.0,
    sequential_image_rate: int = 1,
    start_timestep: int = 0,
    kloss_dataset: bool = False,
    seed: int = None,
) -> List[Trajectory]:
    """Load + preprocess trajectories. Inputs are filenames (members of
    ``dataset_urls``) or (filename, max_count) tuples."""
    if not 1 > image_blackout_ratio >= 0:
        raise ValueError(f"image_blackout_ratio {image_blackout_ratio} not in [0, 1)")
    if image_blackout_ratio != 0 and sequential_image_rate != 1:
        raise ValueError("image_blackout_ratio and sequential_image_rate exclude each other")
    rng = np.random.default_rng(seed)
    norm = NORMALIZATION["kloss" if kloss_dataset else "mujoco"]

    def normalize(array, key):
        mean = np.array(norm[f"{key}_mean"], dtype=np.float32)
        std = np.array(norm[f"{key}_std"], dtype=np.float32)
        return native.normalize(array, mean, std)

    trajectories: List[Trajectory] = []
    for entry in input_files:
        name, max_count = (entry, sys.maxsize) if isinstance(entry, str) else entry
        raw_list = cached_trajectories(name, dataset_urls[name])

        for traj_index, raw in enumerate(raw_list):
            if traj_index >= max_count:
                break

            if kloss_dataset:
                timesteps = len(raw["pos"])
                states = np.stack(
                    [raw["pos"][:, 0], raw["pos"][:, 2]], axis=1
                ).astype(np.float32)
                gripper_pos = np.asarray(raw["tip"], dtype=np.float32)
                gripper_sensors = np.zeros((timesteps, 7), dtype=np.float32)
                gripper_sensors[:, :3] = raw["force"]
                gripper_sensors[:, 6] = raw["contact"]
                image = np.mean(np.asarray(raw["image"], dtype=np.float32), axis=-1)
            else:
                timesteps = len(raw["object-state"])
                states = np.asarray(raw["Cylinder0_pos"][:, :2], dtype=np.float32)
                gripper_pos = np.asarray(raw["eef_pos"], dtype=np.float32)
                gripper_sensors = np.concatenate(
                    [raw["force"], np.asarray(raw["contact"]).reshape(timesteps, 1)],
                    axis=1,
                ).astype(np.float32)
                image = np.asarray(raw["image"], dtype=np.float32)

            _check_shape(name, "gripper_pos", gripper_pos.shape, (timesteps, 3))
            _check_shape(name, "gripper_sensors", gripper_sensors.shape, (timesteps, 7))
            _check_shape(name, "image", image.shape, (timesteps, 32, 32))

            if not use_proprioception:
                gripper_pos[:] = 0
            if not use_haptics:
                gripper_sensors[:] = 0

            mask = make_image_mask(
                timesteps,
                use_vision=use_vision,
                image_blackout_ratio=image_blackout_ratio,
                sequential_image_rate=sequential_image_rate,
                rng=rng,
            )
            image = native.apply_mask(image, mask)

            # Controls from the (possibly zeroed) positions, as the door
            # loader builds them.
            contact = np.asarray(raw["contact"], dtype=np.float32)
            controls = make_controls(gripper_pos, contact)

            observations = {
                "gripper_pos": normalize(gripper_pos, "gripper_pos"),
                "gripper_sensors": normalize(gripper_sensors, "gripper_sensors"),
                "image": image,
            }
            states = normalize(states, "states")
            controls = normalize(controls, "controls")

            trajectories.append(
                Trajectory(
                    states[start_timestep:],
                    {k: v[start_timestep:] for k, v in observations.items()},
                    controls[start_timestep:],
                )
            )
            raw_list[traj_index] = None  # release memory as we go
    return trajectories


def _print_normalization(trajectories) -> None:
    """Print the normalization constants of loaded trajectories. Run on an
    un-normalized load to produce the mean/std pairs of ``NORMALIZATION``."""
    states = np.concatenate([t.states for t in trajectories], axis=0)
    controls = np.concatenate([t.controls for t in trajectories], axis=0)
    observations = {
        k: np.concatenate([t.observations[k] for t in trajectories], axis=0)
        for k in trajectories[0].observations.keys()
    }
    for name, value in {
        "gripper_pos": observations["gripper_pos"],
        "gripper_sensors": observations["gripper_sensors"],
        "states": states,
        "controls": controls,
    }.items():
        print(f"{name} mean: {np.mean(value, axis=0)!r}")
        print(f"{name} std:  {np.std(value, axis=0)!r}")
