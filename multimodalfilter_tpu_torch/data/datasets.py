"""Trajectory windowing datasets (port of
``multimodalfilter_tpu/data/datasets.py``).

Each dataset stacks its windows into contiguous numpy arrays once; the train
loops push them to the device a single time and gather batches there.
``ParticleFilterMeasurementDataset`` keeps only (state, observation) pairs
and the sampling covariance: the train loop draws the perturbations.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from ..native import window_gather as _window_gather
from ..types import Trajectory


def _stack_observations(obs_list: Sequence[Dict[str, np.ndarray]]):
    keys = obs_list[0].keys()
    return {k: np.concatenate([o[k] for o in obs_list], axis=0) for k in keys}


class SingleStepDataset:
    """All (previous_state, state, observation, control) transitions.

    Transition t uses: previous_state = states[t-1], state = states[t],
    observation = observations[t], control = controls[t].
    """

    def __init__(self, trajectories: List[Trajectory]):
        prev_states, states, controls = [], [], []
        obs_list = []
        for traj in trajectories:
            s, o, c = traj.states, traj.observations, traj.controls
            prev_states.append(s[:-1])
            states.append(s[1:])
            obs_list.append({k: v[1:] for k, v in o.items()})
            controls.append(c[1:])
        self.previous_states = np.concatenate(prev_states, axis=0)
        self.states = np.concatenate(states, axis=0)
        self.observations = _stack_observations(obs_list)
        self.controls = np.concatenate(controls, axis=0)

    def __len__(self):
        return self.states.shape[0]


class SubsequenceDataset:
    """Contiguous subsequences of fixed length.

    Default (`stride=None`) takes non-overlapping windows, floor(T/L) of
    them starting at 0, L, 2L, ...; ``stride < subsequence_length`` yields
    overlapping windows. Arrays are window-major: states (B, L, D) etc.
    """

    def __init__(
        self,
        trajectories: List[Trajectory],
        subsequence_length: int,
        stride: int = None,
    ):
        self.subsequence_length = subsequence_length
        if stride is None:
            stride = subsequence_length
        if stride < 1:
            raise ValueError(f"stride must be >= 1, got {stride}")
        states, controls = [], []
        obs_list = []
        for traj in trajectories:
            s, o, c = traj.states, traj.observations, traj.controls
            t = s.shape[0]
            if t < subsequence_length:
                continue
            if stride == subsequence_length:
                num = t // subsequence_length
                starts = np.arange(num, dtype=np.int64) * subsequence_length
            else:
                starts = np.arange(0, t - subsequence_length + 1, stride, dtype=np.int64)
            states.append(_window_gather(s, starts, subsequence_length))
            controls.append(_window_gather(c, starts, subsequence_length))
            obs_list.append({k: _window_gather(v, starts, subsequence_length)
                             for k, v in o.items()})
        if not states:
            raise ValueError(
                "No trajectory long enough for the requested subsequence length"
            )
        self.states = np.concatenate(states, axis=0)
        self.observations = _stack_observations(obs_list)
        self.controls = np.concatenate(controls, axis=0)

    def __len__(self):
        return self.states.shape[0]


class ParticleFilterMeasurementDataset:
    """(state, observation) pairs and the sampling covariance for
    measurement-model pretraining; the train loop samples the perturbed
    states and their log-density targets, fresh every epoch."""

    def __init__(
        self,
        trajectories: List[Trajectory],
        covariance: np.ndarray,
        samples_per_pair: int = 10,
    ):
        self.covariance = np.asarray(covariance, dtype=np.float32)
        self.samples_per_pair = samples_per_pair
        states, obs_list = [], []
        for traj in trajectories:
            states.append(traj.states)
            obs_list.append(dict(traj.observations))
        self.states = np.concatenate(states, axis=0)
        self.observations = _stack_observations(obs_list)

    def __len__(self):
        return self.states.shape[0] * self.samples_per_pair
