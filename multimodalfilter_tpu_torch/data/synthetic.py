"""Synthetic stand-ins for the door and push datasets (port of
``multimodalfilter_tpu/data/synthetic.py``).

The generators emit the key schema each task loader consumes
(``crossmodal/tasks/_door.py``, ``crossmodal/tasks/_push.py``), with
raw-value statistics near its normalization constants and learnable
cross-modality structure: the image renders the true state, proprioception
tracks the end effector, and haptics correlate with contact.

Door schema, per trajectory:
  object-state (T, 5)  = [contact, theta, theta_vel, hinge_x, hinge_y]
  eef_pos (T, 3), ee-force-obs (T, 3), ee-torque-obs (T, 3),
  contact-obs (T,), image (T, 64, 64)  [loader subsamples ::2 -> 32x32]

Push (MuJoCo, ``gentle_push_*``) schema:
  object-state (T, 3), Cylinder0_pos (T, 3), eef_pos (T, 3),
  force (T, 6), contact (T,), image (T, 32, 32)

Push (real robot, ``kloss_*``) schema:
  pos (T, 3) [state = cols 0, 2], tip (T, 3), force (T, 3), contact (T,),
  image (T, 32, 32, 3)  [loader grayscales via channel mean]

``door_trajectories`` and ``push_trajectories`` yield the raw
per-trajectory dicts; the HDF5 writer and the in-memory path
(``data/cache.py::cached_trajectories``) both consume them, so a seed gives
the same arrays either way. A dataset's seed is
``abs(hash(name)) % 2**31``, as in the JAX package: it varies per process
unless PYTHONHASHSEED is set, so a caller that needs a fixed set passes
``seed``.
"""

from __future__ import annotations

import os
import re
from typing import Dict, Iterator, List, Optional

import numpy as np

from .trajectories_file import TrajectoriesFile


def _num_trajectories_for(name: str) -> int:
    """Synthetic trajectory count: honor the count encoded in the filename
    but cap it (synthesis is for tests/benchmarks, not full training runs).
    Override with MMF_TPU_SYNTH_TRAJ."""
    cap = int(os.environ.get("MMF_TPU_SYNTH_TRAJ", "10"))
    match = re.search(r"(\d+)", name)
    encoded = int(match.group(1)) if match else cap
    return max(1, min(cap, encoded))


def _timesteps(rng: np.random.Generator) -> int:
    base = int(os.environ.get("MMF_TPU_SYNTH_T", "120"))
    return base + int(rng.integers(0, base // 4))


def _smooth_noise(rng, shape, std, smoothing=0.9):
    """AR(1)-smoothed Gaussian noise along axis 0."""
    raw = rng.normal(0.0, std, size=shape).astype(np.float32)
    out = np.zeros_like(raw)
    acc = raw[0]
    for t in range(shape[0]):
        acc = smoothing * acc + (1 - smoothing) * raw[t]
        out[t] = acc
    return out * (1.0 / np.sqrt(1 - smoothing**2) * 2.0)


def _render_door_image(theta: float, eef_xy, size: int = 64) -> np.ndarray:
    """Top-down view: door edge rotated by theta around a hinge, plus an
    end-effector blob. Values in [-1, 1] (a /127.5 - 1 grayscale)."""
    img = np.full((size, size), -1.0, dtype=np.float32)
    hinge = np.array([size * 0.15, size * 0.5])
    length = size * 0.7
    ys, xs = np.mgrid[0:size, 0:size].astype(np.float32)
    # Door line: points p = hinge + s * dir, s in [0, length]
    direction = np.array([np.cos(theta), np.sin(theta)], dtype=np.float32)
    rel_y = ys - hinge[0]
    rel_x = xs - hinge[1]
    proj = rel_y * direction[0] + rel_x * direction[1]
    perp = np.abs(-rel_y * direction[1] + rel_x * direction[0])
    door_mask = (proj > 0) & (proj < length) & (perp < 1.5)
    img[door_mask] = 1.0
    # End-effector blob.
    ey = int(np.clip(hinge[0] + eef_xy[0] * size * 0.4 + size * 0.3, 0, size - 1))
    ex = int(np.clip(hinge[1] + eef_xy[1] * size * 0.4, 0, size - 1))
    img[max(0, ey - 1) : ey + 2, max(0, ex - 1) : ex + 2] = 0.6
    return img


def _render_push_image(obj_xy_norm, size: int = 32) -> np.ndarray:
    """Bright blob at the (normalized to [-1,1]) object position."""
    img = np.full((size, size), -1.0, dtype=np.float32)
    cy = int(np.clip((obj_xy_norm[1] * 0.4 + 0.5) * size, 1, size - 2))
    cx = int(np.clip((obj_xy_norm[0] * 0.4 + 0.5) * size, 1, size - 2))
    img[cy - 1 : cy + 2, cx - 1 : cx + 2] = 1.0
    return img


def door_trajectories(n_trajectories: int, seed: int) -> Iterator[Dict[str, np.ndarray]]:
    """The raw door trajectories of one seed, each a dict of (T, ...) arrays
    (what reading them back from their HDF5 file gives)."""
    rng = np.random.default_rng(seed)
    for _ in range(n_trajectories):
        t = _timesteps(rng)
        # Door angle: smooth ramp 0 -> ~1.3 rad with a random rate.
        rate = rng.uniform(0.6, 1.4)
        theta = 1.3 * rate * (1 - np.exp(-np.linspace(0, 3, t))) / (
            1 - np.exp(-3.0)
        )
        theta = (theta + _smooth_noise(rng, (t,), 0.01)).astype(np.float32)
        theta_vel = np.gradient(theta).astype(np.float32)
        hinge = rng.normal(-0.0008, 0.05, size=(2,)).astype(np.float32)

        # End effector approaches, then tracks the handle.
        eef_base = np.array([0.373, -0.108, 1.577], dtype=np.float32)
        eef = eef_base + np.stack(
            [
                0.1 * np.sin(theta) + _smooth_noise(rng, (t,), 0.01),
                0.12 * (np.cos(theta) - 1) + _smooth_noise(rng, (t,), 0.01),
                _smooth_noise(rng, (t,), 0.004),
            ],
            axis=1,
        )
        contact = (np.linspace(0, 1, t) + rng.normal(0, 0.1, t) > 0.3).astype(
            np.float32
        )
        force = (
            np.array([11.0, -1.7, 28.3], dtype=np.float32)
            + contact[:, None] * rng.normal(0, 1, (t, 3)) * [20, 10, 30]
            + _smooth_noise(rng, (t, 3), 1.0) * [15, 8, 25]
        ).astype(np.float32)
        torque = (
            np.array([0.069, 1.66, -0.14], dtype=np.float32)
            + contact[:, None] * rng.normal(0, 1, (t, 3)) * [1.0, 2.0, 0.3]
            + _smooth_noise(rng, (t, 3), 0.5) * [0.8, 2.0, 0.3]
        ).astype(np.float32)

        object_state = np.zeros((t, 5), dtype=np.float32)
        object_state[:, 0] = contact
        object_state[:, 1] = theta
        object_state[:, 2] = theta_vel
        object_state[:, 3] = hinge[0]
        object_state[:, 4] = hinge[1]

        images = np.stack(
            [
                _render_door_image(
                    theta[i], (eef[i, :2] - eef_base[:2]) / 0.15
                )
                for i in range(t)
            ]
        )
        yield {
            "object-state": object_state,
            "eef_pos": eef,
            "ee-force-obs": force,
            "ee-torque-obs": torque,
            "contact-obs": contact,
            "image": images,
        }


def _synthesize_door(path: str, n_trajectories: int, seed: int) -> None:
    _write(path, door_trajectories(n_trajectories, seed))


def push_trajectories(n_trajectories: int, seed: int,
                      kloss: bool) -> Iterator[Dict[str, np.ndarray]]:
    """The raw push trajectories of one seed, MuJoCo (``gentle_push``) or
    real-robot (``kloss``) schema. Draws from the generator in the JAX
    writer's order: the per-timestep force draws come last, one timestep
    after another."""
    rng = np.random.default_rng(seed)
    for _ in range(n_trajectories):
        t = _timesteps(rng)
        if kloss:
            obj_mean = np.array([-0.0028, -0.0003], dtype=np.float32)
            obj_std = np.array([0.064, 0.066], dtype=np.float32)
            tip_mean = np.array([-0.0036, 0.0, 0.0002], dtype=np.float32)
        else:
            obj_mean = np.array([0.497, -0.009], dtype=np.float32)
            obj_std = np.array([0.057, 0.061], dtype=np.float32)
            tip_mean = np.array([0.468, -0.0018, 0.880], dtype=np.float32)

        # Object pushed along a smooth random direction when in contact.
        contact = (np.sin(np.linspace(0, 6, t) + rng.uniform(0, 6)) > 0).astype(
            np.float32
        )
        push_dir = rng.normal(size=(2,)).astype(np.float32)
        push_dir /= np.linalg.norm(push_dir)
        steps = contact[:, None] * push_dir * rng.uniform(0.0005, 0.002)
        obj = obj_mean + np.cumsum(
            steps + _smooth_noise(rng, (t, 2), 0.0003), axis=0
        )

        # EEF trails slightly behind the object.
        eef = np.concatenate(
            [
                obj - push_dir * 0.01 + _smooth_noise(rng, (t, 2), 0.002),
                np.zeros((t, 1), dtype=np.float32),
            ],
            axis=1,
        ).astype(np.float32)
        eef += tip_mean - eef.mean(axis=0)

        obj3 = np.concatenate(
            [obj, np.zeros((t, 1), dtype=np.float32)], axis=1
        ).astype(np.float32)

        obj_norm = (obj - obj_mean) / obj_std
        images = np.stack([_render_push_image(obj_norm[i]) for i in range(t)])

        if kloss:
            force = np.stack([
                (contact[i] * rng.normal(0, 1, (3,)) * [1.5, 1.5, 0.003]).astype(
                    np.float32)
                for i in range(t)
            ])
            yield {
                "pos": np.stack([obj[:, 0], np.zeros(t, np.float32), obj[:, 1]],
                                axis=1).astype(np.float32),
                "tip": eef,
                "force": force,
                "contact": contact,
                "image": np.repeat(images[:, :, :, None], 3, axis=3).astype(np.float32),
            }
        else:
            force = np.stack([
                np.concatenate([
                    np.array([0.49, 0.045, -3.28], dtype=np.float32)
                    + contact[i] * rng.normal(0, 1, (3,)) * [1.2, 1.2, 1.5],
                    np.array([-0.003, 0.011, -0.0008], dtype=np.float32)
                    + contact[i] * rng.normal(0, 1, (3,)) * [0.1, 0.1, 0.01],
                ]).astype(np.float32)
                for i in range(t)
            ])
            yield {
                "object-state": obj3,
                "Cylinder0_pos": obj3,
                "eef_pos": eef,
                "force": force,
                "contact": contact,
                "image": images,
            }


def _write(path: str, trajectories) -> None:
    """The HDF5 writer over a trajectory generator, one timestep at a time."""
    with TrajectoriesFile(path, "w") as f:
        for raw in trajectories:
            for i in range(len(next(iter(raw.values())))):
                f.add_timestep({k: v[i] for k, v in raw.items()})
            f.complete_trajectory()


def _synthesize_push(path: str, n_trajectories: int, seed: int, kloss: bool) -> None:
    _write(path, push_trajectories(n_trajectories, seed, kloss))


def _dataset_seed(name: str) -> int:
    """The JAX package's seed of a named synthetic dataset."""
    return abs(hash(name)) % (2**31)


def _named_generator(name: str, seed: Optional[int]) -> Iterator[Dict[str, np.ndarray]]:
    n = _num_trajectories_for(name)
    seed = _dataset_seed(name) if seed is None else seed
    if name.startswith("panda_door"):
        return door_trajectories(n, seed)
    if name.startswith("gentle_push"):
        return push_trajectories(n, seed, kloss=False)
    if name.startswith("kloss"):
        return push_trajectories(n, seed, kloss=True)
    raise ValueError(f"Unknown dataset name for synthesis: {name!r}")


def named_trajectories(name: str, seed: Optional[int] = None) -> List[Dict[str, np.ndarray]]:
    """A synthetic stand-in for a known dataset filename, in memory."""
    return list(_named_generator(name, seed))


def synthesize_named_dataset(name: str, path: str, seed: Optional[int] = None) -> None:
    """Generate a synthetic stand-in for a known dataset filename at `path`
    (HDF5)."""
    trajectories = _named_generator(name, seed)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    _write(path, trajectories)
