"""Synthetic stand-ins for the door datasets (port of the door part of
``multimodalfilter_tpu/data/synthetic.py``).

The generators emit the key schema the door loader consumes
(``crossmodal/tasks/_door.py``), with raw-value statistics near its
normalization constants and learnable cross-modality structure: the image
renders the true state, proprioception tracks the end effector, and haptics
correlate with contact.

Door schema, per trajectory:
  object-state (T, 5)  = [contact, theta, theta_vel, hinge_x, hinge_y]
  eef_pos (T, 3), ee-force-obs (T, 3), ee-torque-obs (T, 3),
  contact-obs (T,), image (T, 64, 64)  [loader subsamples ::2 -> 32x32]

``door_trajectories`` yields the raw per-trajectory dicts; the HDF5 writer
and the in-memory path (``data/cache.py::cached_trajectories``) both consume
it, so a seed gives the same arrays either way. A dataset's seed is
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
    """The HDF5 writer over ``door_trajectories``, one timestep at a time."""
    with TrajectoriesFile(path, "w") as f:
        for raw in door_trajectories(n_trajectories, seed):
            for i in range(len(raw["object-state"])):
                f.add_timestep({k: v[i] for k, v in raw.items()})
            f.complete_trajectory()


def _dataset_seed(name: str) -> int:
    """The JAX package's seed of a named synthetic dataset."""
    return abs(hash(name)) % (2**31)


def _check_door(name: str) -> None:
    if name.startswith(("gentle_push", "kloss")):
        raise NotImplementedError(
            f"synthetic {name!r}: the push task's datasets are not ported yet "
            "(ROADMAP A11)"
        )
    if not name.startswith("panda_door"):
        raise ValueError(f"Unknown dataset name for synthesis: {name!r}")


def named_trajectories(name: str, seed: Optional[int] = None) -> List[Dict[str, np.ndarray]]:
    """A synthetic stand-in for a known dataset filename, in memory."""
    _check_door(name)
    seed = _dataset_seed(name) if seed is None else seed
    return list(door_trajectories(_num_trajectories_for(name), seed))


def synthesize_named_dataset(name: str, path: str, seed: Optional[int] = None) -> None:
    """Generate a synthetic stand-in for a known dataset filename at `path`
    (HDF5)."""
    _check_door(name)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    seed = _dataset_seed(name) if seed is None else seed
    _synthesize_door(path, _num_trajectories_for(name), seed)
