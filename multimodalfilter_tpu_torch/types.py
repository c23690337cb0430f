"""Belief and data containers (port of ``multimodalfilter_tpu/types.py``)."""

from __future__ import annotations

from typing import Dict, NamedTuple

import numpy as np
import torch


class Trajectory(NamedTuple):
    """A single trajectory: states (T, state_dim), observations dict of
    (T, ...) arrays, controls (T, control_dim), all numpy."""

    states: np.ndarray
    observations: Dict[str, np.ndarray]
    controls: np.ndarray


class ParticleBelief(NamedTuple):
    """Particle filter belief.

    particles: (N, M, state_dim)
    log_weights: (N, M), normalized so logsumexp over M is 0.
    """

    particles: torch.Tensor
    log_weights: torch.Tensor


class GaussianBelief(NamedTuple):
    """Kalman filter belief: mean (N, state_dim), cov (N, state_dim,
    state_dim)."""

    mean: torch.Tensor
    cov: torch.Tensor
