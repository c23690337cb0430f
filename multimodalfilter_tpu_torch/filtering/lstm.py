"""LSTM baseline filter (port of ``multimodalfilter_tpu/filtering/lstm.py``).

All T*N frames are encoded in one batch, then the LSTM cells step over time.
The belief is the cells' carry, one (c, h) a layer; ``initialize_beliefs``
zeroes it and ignores the mean and covariance, as the reference does. The
filter draws no random numbers: the noise, uniforms and generator that the
particle filters take are accepted and ignored, so every caller can hand
them to any def.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
from torch import nn

from .base import FilterDef
from .pf import _tree_map


@dataclasses.dataclass(frozen=True, eq=False)
class LSTMFilterDef(FilterDef):
    net: nn.Module  # LSTMFilterNet
    state_dim: int
    # The image encoder's folded tail (with_fold_tail); the LSTM has no
    # compute dtype, as in the JAX package.
    fold_tail: bool = False

    def module(self) -> nn.Module:
        return self.net

    def initialize_beliefs(self, mean, covariance, *, train: bool,
                           generator: Optional[torch.Generator] = None, eps=None):
        """The zero carry, (N, lstm_hidden_dim) per c and h of each layer."""
        del covariance, train, generator, eps
        n = mean.shape[0]
        return tuple(
            tuple(mean.new_zeros((n, self.net.lstm_hidden_dim)) for _ in range(2))
            for _ in range(self.net.lstm_num_layers)
        )

    def step(self, belief, observations, controls, *, train: bool,
             enabled: Optional[Tuple[bool, ...]] = None, eps=None, uniforms=None,
             generator: Optional[torch.Generator] = None):
        del enabled, eps, uniforms, generator
        with torch.set_grad_enabled(train):
            return self.net(observations, controls, belief, fold_tail=self.fold_tail)

    def forward_loop(self, belief, observations_seq, controls_seq, *, train: bool,
                     enabled: Optional[Tuple[bool, ...]] = None, eps_seq=None,
                     uniforms_seq=None, generator: Optional[torch.Generator] = None):
        """observations_seq: dict of (T, N, ...); controls_seq (T, N, C).
        Returns (final carry, estimates (T, N, state_dim))."""
        del enabled, eps_seq, uniforms_seq, generator
        with torch.set_grad_enabled(train):
            t, n = controls_seq.shape[:2]
            flat_obs = _tree_map(lambda v: v.reshape((t * n,) + v.shape[2:]),
                                 observations_seq)
            features = self.net.encode(
                flat_obs, controls_seq.reshape((t * n,) + controls_seq.shape[2:]),
                fold_tail=self.fold_tail,
            ).reshape(t, n, -1)
            packed = self.net.packed_cells()
            estimates = []
            for i in range(t):
                belief, estimate = self.net.lstm_step(belief, features[i], packed)
                estimates.append(estimate)
            return belief, torch.stack(estimates)
