"""Virtual-sensor extended Kalman filter (port of
``multimodalfilter_tpu/filtering/ekf.py``):

  predict:  F = d(dynamics mean)/d(state)   [torch.func.jacrev under vmap]
            mean' = dynamics(mean);  cov' = F cov F^T + Q (Q = L L^T)
  update:   virtual sensor -> (z, R_tril); the observation model is the
            identity: S = cov' + R, K = cov' S^{-1} (Cholesky solve),
            mean <- mean' + K (z - mean'),  cov <- (I - K) cov'

The belief (mean, cov) is the loop's carry. ``forward_loop`` runs the
virtual sensor and the control encoder once over all T*N frames, so the time
loop holds only the EKF algebra. F stays differentiable: BPTT reaches the
dynamics weights through it. The JAX package takes F with ``jax.jacfwd``;
``jacrev`` gives the same matrix (three VJPs for three state dimensions)
and dispatches about a third of the host time of ``torch.func.jacfwd``.

The linear algebra never waits on the host: ``cholesky_ex`` and triangular
solves instead of ``cholesky``, which checks its result on the host (and
raises where JAX returns NaN). Where a factorisation fails its row is set
to NaN, as JAX's is. The filter draws no random numbers: the noise,
uniforms and generator that the particle filters take are accepted and
ignored, so every caller can hand them to any def.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
from torch import nn
from torch.func import functional_call, jacrev, vmap

from ..types import GaussianBelief
from .base import DynamicsDef, FilterDef, VirtualSensorDef
from .pf import _tree_map


def _nan_where(failed, x):
    """x with the rows of a batch where `failed` (B,) set to NaN."""
    mask = failed.reshape(failed.shape + (1,) * (x.dim() - failed.dim()))
    return torch.where(mask, torch.nan, x)


def cholesky(a):
    """Lower Cholesky factor of a batch of matrices; NaN where one is not
    positive definite (JAX's result), with no check on the host."""
    chol, info = torch.linalg.cholesky_ex(a)
    return _nan_where(info > 0, chol)


def inverse(a):
    """Batched matrix inverse; NaN where a matrix is singular, with no
    check on the host."""
    inv, info = torch.linalg.inv_ex(a)
    return _nan_where(info > 0, inv)


def _kalman_update(pred_mean, pred_cov, z, r_tril):
    """Identity-observation Kalman update, batched over N."""
    s = pred_cov + r_tril @ r_tril.mT
    # K = pred_cov S^{-1}; S is symmetric positive definite, so
    # K^T = S^{-1} pred_cov = L^{-T} L^{-1} pred_cov with S = L L^T (pred_cov
    # is symmetric).
    chol = cholesky(s)
    y = torch.linalg.solve_triangular(chol, pred_cov, upper=False)
    k = torch.linalg.solve_triangular(chol.mT, y, upper=True).mT
    mean = pred_mean + torch.einsum("nij,nj->ni", k, z - pred_mean)
    eye = torch.eye(pred_cov.shape[-1], dtype=pred_cov.dtype, device=pred_cov.device)
    cov = (eye - k) @ pred_cov
    # Symmetrise: the (I - K) P form drifts asymmetric in fp32 over long
    # loops; the math is unchanged.
    return mean, 0.5 * (cov + cov.mT)


@dataclasses.dataclass(frozen=True, eq=False)
class VirtualSensorEKFDef(FilterDef):
    dynamics_model: DynamicsDef
    virtual_sensor_model: VirtualSensorDef  # or a measurement-fusion def
    state_dim: int
    # Run the dynamics' control encoder once over all T*N rows of
    # forward_loop (the JAX field; F is taken with respect to the state
    # either way).
    hoist_ctrl: bool = True

    def module(self) -> nn.Module:
        return nn.ModuleDict({
            "dynamics_model": self.dynamics_model.module(),
            "virtual_sensor_model": self.virtual_sensor_model.module(),
        })

    def initialize_beliefs(self, mean, covariance, *, train: bool,
                           generator: Optional[torch.Generator] = None, eps=None):
        del train, generator, eps
        return GaussianBelief(mean, covariance)

    def measurement_initialize_beliefs(self, observations, *, train: bool = False):
        """The belief of the virtual sensor alone: mean z, covariance R."""
        del train
        z, r_tril = self.virtual_sensor_model.apply(observations)
        return GaussianBelief(z, r_tril @ r_tril.mT)

    def _dynamics_step(self, hoisted: bool, dynamics_params=None):
        """(states, controls or hoisted control features) -> (new states,
        scale_tril): the dynamics net, or the net called with
        `dynamics_params` in place of its own (a child of a stacked chain,
        ``fusion.py``)."""
        dyn = self.dynamics_model
        if dynamics_params is None:
            return dyn.apply_with_control_features if hoisted else dyn.apply
        if hoisted:
            return lambda s, c: functional_call(dyn.net, dynamics_params, (s,),
                                                {"control_features": c})
        return lambda s, c: functional_call(dyn.net, dynamics_params, (s, c))

    def predict(self, belief: GaussianBelief, controls, *, ctrl_feat=None,
                dynamics_params=None):
        """EKF predict step. With `ctrl_feat` (hoisted control features,
        ``precompute_control_features``) the dynamics runs its
        carry-dependent remainder only and `controls` is ignored. With
        `dynamics_params` the dynamics net runs on those parameters."""
        mean, cov = belief
        step = self._dynamics_step(ctrl_feat is not None, dynamics_params)
        ctrl_in = controls if ctrl_feat is None else ctrl_feat

        def mean_fn(s, c):
            new, tril = step(s[None], c[None])
            return new[0], (new[0], tril[0])

        f, (pred_mean, q_tril) = vmap(jacrev(mean_fn, has_aux=True))(mean, ctrl_in)
        pred_cov = f @ cov @ f.mT + q_tril @ q_tril.mT
        return pred_mean, pred_cov

    def update_from_virtual(self, belief: GaussianBelief, z, r_tril, controls, *,
                            ctrl_feat=None, dynamics_params=None):
        """Predict, then update from a precomputed virtual measurement.
        Returns (new belief, its mean)."""
        pred_mean, pred_cov = self.predict(belief, controls, ctrl_feat=ctrl_feat,
                                           dynamics_params=dynamics_params)
        mean, cov = _kalman_update(pred_mean, pred_cov, z, r_tril)
        return GaussianBelief(mean, cov), mean

    def precompute_control_features(self, controls_seq):
        """(T, N, C) controls -> (T, N, U) control features, or None when
        hoisting is off or the dynamics net does not split."""
        if not (self.hoist_ctrl and self.dynamics_model.supports_control_hoist):
            return None
        t, n = controls_seq.shape[:2]
        cf = self.dynamics_model.encode_controls(
            controls_seq.reshape((t * n,) + controls_seq.shape[2:]))
        return cf.reshape((t, n) + cf.shape[1:])

    def precompute_virtual(self, observations_seq,
                           enabled: Optional[Tuple[bool, ...]] = None):
        """The virtual sensor over all (T, N) frames as one batch:
        (z (T, N, D), r_tril (T, N, D, D))."""
        leaf = next(iter(observations_seq.values()))
        t, n = leaf.shape[:2]
        flat = _tree_map(lambda v: v.reshape((t * n,) + v.shape[2:]), observations_seq)
        z, r_tril = self.virtual_sensor_model.apply(flat, enabled=enabled)
        return z.reshape((t, n) + z.shape[1:]), r_tril.reshape((t, n) + r_tril.shape[1:])

    def step(self, belief, observations, controls, *, train: bool,
             enabled: Optional[Tuple[bool, ...]] = None, eps=None, uniforms=None,
             generator: Optional[torch.Generator] = None):
        del eps, uniforms, generator
        with torch.set_grad_enabled(train):
            z, r_tril = self.virtual_sensor_model.apply(observations, enabled=enabled)
            return self.update_from_virtual(belief, z, r_tril, controls)

    def forward_loop(self, belief, observations_seq, controls_seq, *, train: bool,
                     enabled: Optional[Tuple[bool, ...]] = None, eps_seq=None,
                     uniforms_seq=None, generator: Optional[torch.Generator] = None):
        """observations_seq: dict of (T, N, ...); controls_seq (T, N, C).
        Returns (final belief, estimates (T, N, D))."""
        del eps_seq, uniforms_seq, generator
        with torch.set_grad_enabled(train):
            z_seq, r_seq = self.precompute_virtual(observations_seq, enabled)
            cf_seq = self.precompute_control_features(controls_seq)
            estimates = []
            for i in range(controls_seq.shape[0]):
                belief, mean = self.update_from_virtual(
                    belief, z_seq[i], r_seq[i], controls_seq[i],
                    ctrl_feat=None if cf_seq is None else cf_seq[i],
                )
                estimates.append(mean)
            return belief, torch.stack(estimates)
