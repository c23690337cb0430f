"""Eval batch assembly and belief initialization (port of
``crossmodal/_eval_batching.py``).

All eval trajectories are truncated to the common minimum length and stacked
on axis 1, time-major (T, N, ...); beliefs start at the ground-truth state[0]
with 0.1*I covariance. The batch is loaded once with masking off: the
observations and controls stay on the model's device, cached across the
stochastic repeats, and each repeat re-applies the image blackout there. The
states stay numpy (the metrics are numpy).
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from ..data.augment import apply_image_blackout
from . import _eval_state as S


def _stack_axis1(arrays: List[np.ndarray], t_min: int) -> np.ndarray:
    """np.stack([a[:t_min] for a in arrays], axis=1) of float32 arrays (the
    numpy path of the JAX package's native.stack_axis1)."""
    return np.stack([np.ascontiguousarray(a, dtype=np.float32)[:t_min] for a in arrays],
                    axis=1)


def _device():
    return S.filter_model.device


def get_eval_batch(tile: int = 1):
    """Load and batch the eval trajectories, cached across repeated runs.
    Returns (states (T, N, D) numpy, observations dict of (T, N, ...) and
    controls (T, N, C) on the model's device).

    `tile` > 1 repeats the batch along the trajectory axis, repeat-major (row
    r*N + i is repeat r of trajectory i), for the batched-repeats path. With
    an image blackout ratio, every call re-masks the images on the device,
    from a generator seeded by the repeat stream ``S.rng``."""
    blackout_ratio = S.dataset_args.get("image_blackout_ratio", 0.0)
    cache_key = tuple(sorted(S.dataset_args.items()))

    if cache_key not in S.batch_cache:
        load_args = dict(S.dataset_args)
        load_args["image_blackout_ratio"] = 0.0  # re-masked on the device below
        trajectories = S.task.get_eval_trajectories(**load_args)
        if not isinstance(trajectories, list):
            raise TypeError(f"eval trajectories are a {type(trajectories).__name__}")

        min_timesteps = min(s.shape[0] for s, o, c in trajectories)
        states = _stack_axis1([s for s, o, c in trajectories], min_timesteps)
        controls = _stack_axis1([c for s, o, c in trajectories], min_timesteps)
        observations = {
            k: _stack_axis1([o[k] for s, o, c in trajectories], min_timesteps)
            for k in trajectories[0].observations.keys()
        }
        device = _device()
        observations = {k: torch.from_numpy(v).to(device) for k, v in observations.items()}
        controls = torch.from_numpy(controls).to(device)
        S.batch_cache[cache_key] = (states, observations, controls)

    states, observations, controls = S.batch_cache[cache_key]
    if tile > 1:
        tiled_key = (cache_key, "tile", tile)
        if tiled_key not in S.batch_cache:

            def reps(v):
                return (1, tile) + (1,) * (v.ndim - 2)

            S.batch_cache[tiled_key] = (
                np.tile(states, reps(states)),
                {k: v.repeat(reps(v)) for k, v in observations.items()},
                controls.repeat(reps(controls)),
            )
        states, observations, controls = S.batch_cache[tiled_key]
    if blackout_ratio > 0:
        generator = torch.Generator(device=_device())
        generator.manual_seed(int(S.rng.integers(2**31)))
        observations = dict(observations)
        observations["image"] = apply_image_blackout(
            generator, observations["image"], blackout_ratio
        )
    return states, observations, controls


def random_initialize_beliefs(states, state_dim: int) -> None:
    """The reference's random belief init: mean = true initial state,
    covariance 0.1*I. The init tensors are cached on the device."""
    n = states.shape[1]
    init_key = ("init_tensors", n, state_dim, id(states))
    if init_key not in S.batch_cache:
        cov = np.tile(np.eye(state_dim, dtype=np.float32) * 0.1, (n, 1, 1))
        device = _device()
        S.batch_cache[init_key] = (torch.from_numpy(np.ascontiguousarray(states[0])).to(device),
                                   torch.from_numpy(cov).to(device))
    mean0, cov = S.batch_cache[init_key]
    S.filter_model.initialize_beliefs(mean=mean0, covariance=cov)


def initialize_beliefs_for_eval(states, observations, measurement_initialize) -> str:
    """Measurement init when requested and supported, else random init;
    shared by the sequential and batched-repeats eval paths. The particle
    filters have no measurement init, so they take the random branch."""
    if measurement_initialize and hasattr(
        S.filter_model.definition, "measurement_initialize_beliefs"
    ):
        S.filter_model.measurement_initialize_beliefs(
            {k: v[0] for k, v in observations.items()}
        )
        return "measurement"
    random_initialize_beliefs(states, S.filter_model.state_dim)
    return "random"
