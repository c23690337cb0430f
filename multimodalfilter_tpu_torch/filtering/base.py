"""Filter runtime base (port of ``multimodalfilter_tpu/filtering/base.py``).

As in the JAX package, a *def* is a frozen dataclass of networks plus static
config. Here the networks are ``nn.Module``s that own their parameters, so
the methods take no ``params`` argument; ``module()`` returns the module
tree whose state-dict keys are the def's flax param paths.

The serving options that the JAX package keeps on its flax nets, the
observation encoders' compute ``dtype`` and ``fold_tail``, are fields of the
defs that hold an observation net, passed to the net on each call
(``encoder_options``): defs rebuilt by ``utils/precision.py`` share the nets
and their parameters and still compute as each was built.
"""

from __future__ import annotations

import abc
import dataclasses
import inspect
from typing import Any, Optional, Tuple

import torch
from torch import nn


def encoder_options(defn) -> dict:
    """The keyword arguments that carry a def's serving options (``dtype``,
    ``fold_tail``) to its net: none where both are off, so a net that has
    no observation encoders takes the call as before."""
    options = {}
    if getattr(defn, "dtype", None) is not None:
        options["dtype"] = defn.dtype
    if getattr(defn, "fold_tail", False):
        options["fold_tail"] = True
    return options


@dataclasses.dataclass(frozen=True, eq=False)
class DynamicsDef:
    """Wraps a dynamics network: (states (B, D), controls (B, C)) ->
    (new_states (B, D), scale_tril (B, D, D))."""

    net: nn.Module

    def module(self) -> nn.Module:
        return self.net

    def apply(self, states, controls):
        return self.net(states, controls)

    @property
    def supports_control_hoist(self) -> bool:
        """True when the net splits into a carry-independent control encoder
        and a remainder (DynamicsNet does)."""
        return hasattr(self.net, "encode_controls") and hasattr(
            self.net, "from_control_features"
        )

    def encode_controls(self, controls):
        return self.net.encode_controls(controls)

    def apply_with_control_features(self, states, control_features):
        return self.net.from_control_features(states, control_features)

    def forward_loop(self, initial_states, controls_seq):
        """Noise-free mean rollout. controls_seq: (T, N, C). Returns
        (states (T, N, D), scale_trils (T, N, D, D)). The control encoder
        runs once over all T*N rows when the net splits."""
        t, n = controls_seq.shape[:2]
        if self.supports_control_hoist:
            feats = self.encode_controls(
                controls_seq.reshape((t * n,) + controls_seq.shape[2:])
            )
            feats = feats.reshape((t, n) + feats.shape[1:])
            step = self.apply_with_control_features
        else:
            feats, step = controls_seq, self.apply
        states, scale_trils = [], []
        carry = initial_states
        for i in range(t):
            carry, scale_tril = step(carry, feats[i])
            states.append(carry)
            scale_trils.append(scale_tril)
        return torch.stack(states), torch.stack(scale_trils)


@dataclasses.dataclass(frozen=True, eq=False)
class MeasurementDef:
    """Wraps a particle-filter measurement network:
    (states (N, M, D), observations) -> log-likelihoods (N, M)."""

    net: nn.Module
    dtype: Any = None  # the observation encoders' compute dtype
    fold_tail: bool = False  # the image encoder's folded tail

    def module(self) -> nn.Module:
        return self.net

    def log_likelihoods(self, states, observations,
                        enabled: Optional[Tuple[bool, ...]] = None):
        del enabled  # single-modality-set model; fusion is in fusion.py
        return self.net(states, observations, **encoder_options(self))

    def encode_observations(self, observations,
                            enabled: Optional[Tuple[bool, ...]] = None):
        """Carry-independent features; ``forward_loop`` hoists this over all
        T*N frames. Nets without the split pass observations through."""
        del enabled
        if hasattr(self.net, "encode_obs"):
            return self.net.encode_obs(observations, **encoder_options(self))
        return observations

    def log_likelihoods_from_features(self, states, features,
                                      enabled: Optional[Tuple[bool, ...]] = None):
        del enabled
        if hasattr(self.net, "encode_obs"):
            return self.net.from_features(states, features)
        return self.net(states, features)


@dataclasses.dataclass(frozen=True, eq=False)
class VirtualSensorDef:
    """Wraps a virtual sensor network: observations -> (z (N, D),
    scale_tril (N, D, D))."""

    net: nn.Module
    dtype: Any = None  # the observation encoders' compute dtype
    fold_tail: bool = False  # the image encoder's folded tail

    def module(self) -> nn.Module:
        return self.net

    def apply(self, observations, enabled: Optional[Tuple[bool, ...]] = None):
        del enabled  # one modality set; fusion is in fusion.py
        return self.net(observations, **encoder_options(self))


class FilterDef(abc.ABC):
    """Abstract filter definition: ``initialize_beliefs`` and a one-step
    ``step`` over an explicit belief carry."""

    state_dim: int

    @abc.abstractmethod
    def module(self) -> nn.Module:
        ...

    @abc.abstractmethod
    def initialize_beliefs(self, mean, covariance, *, train: bool, generator):
        ...

    @abc.abstractmethod
    def step(self, belief, observations, controls, *, train: bool,
             enabled: Optional[Tuple[bool, ...]] = None, generator=None):
        """One filter timestep: returns (new_belief, state_estimate (N, D))."""
        ...


def measurement_initialize(definition, observations, *, enabled, train: bool):
    """``definition``'s belief from one frame's `observations` alone (the
    Kalman filters' virtual sensors). A def whose method takes ``enabled``
    (the fusion filters) gets it; the plain EKF's takes none, as the JAX
    facade's ``TypeError`` fallback gives it none."""
    fn = getattr(definition, "measurement_initialize_beliefs", None)
    if fn is None:
        raise AttributeError(f"{type(definition).__name__} does not support "
                             "measurement initialization")
    kwargs = {"enabled": enabled} if "enabled" in inspect.signature(fn).parameters else {}
    return fn(observations, train=train, **kwargs)
