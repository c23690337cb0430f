"""Multimodal fusion (port of ``multimodalfilter_tpu/filtering/fusion.py``):
crossmodal (learned-gate) and unimodal (precision-weighted) fusion of
per-modality filters and measurement models.

  CrossmodalPFMeasurementDef, PFWeightDef   particle filters
  CrossmodalKFDef, KFWeightDef              K child EKFs, gated posteriors
  UnimodalKFDef                             K independent child EKFs
  CrossmodalVirtualSensorDef                K virtual sensors, gated
  UnimodalVirtualSensorDef                  K virtual sensors, precisions

Kept from the reference's numerics, deliberately:
  * the PF fusion feeds RAW per-modality log-likelihoods into logsumexp
    with the gate's log-weights (no max-normalisation);
  * the PF image-blackout override adds -1e9 (not -inf) to the image gate;
  * the 1e-9 epsilons at the reference's places;
  * CrossmodalVirtualSensorDef's covariance multiplier is the product of
    the weights over modalities and state dimensions;
  * UnimodalVirtualSensorDef's "precision" is the elementwise
    1/(scale_tril + 1e-9), not a matrix inverse, and its second return
    value is a covariance in the scale_tril slot (which the EKF squares).

The KF defs run their children in a Python loop. ``stack_children`` is kept
with the JAX package's default: there it runs the children as one vmapped
chain, bitwise equal to the loop, to cut launches (ROADMAP A8).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
from torch import nn

from ..types import GaussianBelief
from .base import FilterDef
from .ekf import VirtualSensorEKFDef, cholesky, inverse

_BLACKOUT_EPS = 1e-8
_NEG_BIG = 1.0e9


def weighted_average(predictions, weights):
    """Normalise weights over the modality axis 0, weighted sum."""
    if predictions.shape != weights.shape:
        raise ValueError(f"{tuple(predictions.shape)} != {tuple(weights.shape)}")
    weights = weights / (torch.sum(weights, dim=0) + 1e-9)
    return torch.sum(weights * predictions, dim=0)


def _blackout_mask(observations) -> torch.Tensor:
    """(N,) bool: True where the image frame is all (near-)zero."""
    image = observations["image"]
    return image.reshape(image.shape[0], -1).abs().sum(dim=1) < _BLACKOUT_EPS


def _normalize_enabled(enabled: Optional[Tuple[bool, ...]], count: int):
    if enabled is None:
        enabled = (True,) * count
    if len(enabled) != count or not any(enabled):
        raise ValueError(f"enabled={enabled} for {count} modality models")
    return tuple(enabled)


@dataclasses.dataclass(frozen=True, eq=False)
class PFWeightDef:
    """Gate over observations -> (N, K) log-weights; optional image-blackout
    override on modality 0."""

    net: nn.Module  # PFWeightNet
    know_image_blackout: bool = False

    def module(self) -> nn.Module:
        return self.net

    def log_weights(self, observations):
        out = self.net(observations)
        if self.know_image_blackout:
            penalty = torch.where(_blackout_mask(observations), -_NEG_BIG, 0.0)
            out = torch.cat([out[:, :1] + penalty[:, None].to(out.dtype),
                             out[:, 1:]], dim=1)
        return out


@dataclasses.dataclass(frozen=True, eq=False)
class CrossmodalPFMeasurementDef:
    """K per-modality log-likelihood models fused by
    logsumexp(gate_log_weights + log_likelihoods) over the modality axis.
    With crossmodal_weight_model=None modalities weigh equally (the
    "unimodal PF")."""

    measurement_models: Tuple  # MeasurementDefs
    crossmodal_weight_model: Optional[PFWeightDef]

    def module(self) -> nn.Module:
        tree = nn.ModuleDict({
            "measurement_models": nn.ModuleDict({
                str(i): mm.module() for i, mm in enumerate(self.measurement_models)
            })
        })
        if self.crossmodal_weight_model is not None:
            tree["crossmodal_weight_model"] = self.crossmodal_weight_model.module()
        return tree

    def _fuse(self, lls, log_w, enabled):
        """lls (N, M, K_enabled); log_w (N, K) or None -> (N, M)."""
        if log_w is not None:
            log_w = log_w[:, [i for i, e in enumerate(enabled) if e]]
            lls = log_w[:, None, :] + lls
        return torch.logsumexp(lls, dim=2)

    def log_likelihoods(self, states, observations,
                        enabled: Optional[Tuple[bool, ...]] = None):
        enabled = _normalize_enabled(enabled, len(self.measurement_models))
        lls = torch.stack([
            mm.log_likelihoods(states, observations)
            for mm, e in zip(self.measurement_models, enabled) if e
        ], dim=2)
        log_w = None
        if self.crossmodal_weight_model is not None:
            log_w = self.crossmodal_weight_model.log_weights(observations)
        return self._fuse(lls, log_w, enabled)

    def encode_observations(self, observations,
                            enabled: Optional[Tuple[bool, ...]] = None):
        """Carry-independent features: per-enabled-model obs encodings
        (keys "0", "1", ...) and the gate log-weights ("_log_weights")."""
        enabled = _normalize_enabled(enabled, len(self.measurement_models))
        features = {
            str(i): mm.encode_observations(observations)
            for i, mm in enumerate(self.measurement_models) if enabled[i]
        }
        if self.crossmodal_weight_model is not None:
            features["_log_weights"] = self.crossmodal_weight_model.log_weights(
                observations
            )
        return features

    def log_likelihoods_from_features(self, states, features,
                                      enabled: Optional[Tuple[bool, ...]] = None):
        enabled = _normalize_enabled(enabled, len(self.measurement_models))
        lls = torch.stack([
            mm.log_likelihoods_from_features(states, features[str(i)])
            for i, mm in enumerate(self.measurement_models) if enabled[i]
        ], dim=2)
        return self._fuse(lls, features.get("_log_weights"), enabled)


# ---------------------------------------------------------------------------
# Kalman-filter fusion (posterior level)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True, eq=False)
class KFWeightDef:
    """Gate over observations -> (K, N, state_dim) weights, normalised over
    the modalities."""

    net: nn.Module  # KFWeightNet

    def module(self) -> nn.Module:
        return self.net

    def apply(self, observations):
        return self.net(observations)


def _enabled_indices(enabled) -> Tuple[int, ...]:
    return tuple(i for i, e in enumerate(enabled) if e)


def _blackout_override(weights, blackout):
    """On all-zero image frames the (image, force) weights become
    (1e-9, 1 - 1e-9); elsewhere they are the gate's. weights (K, ..., D),
    blackout (..., 1)."""
    return torch.stack([torch.where(blackout, 1e-9, weights[0]),
                        torch.where(blackout, 1.0 - 1e-9, weights[1])])


def _calculate_weighted_states(state_weights, unimodal_states, unimodal_covariances):
    """Means: the normalised weighted average. Covariances:
    sum_k (w w^T) * cov_k with the RAW (unnormalised) weights."""
    weighted_states = weighted_average(unimodal_states, state_weights)
    w_outer = state_weights[..., :, None] * state_weights[..., None, :]
    return weighted_states, torch.sum(w_outer * unimodal_covariances, dim=0)


def _indicator_weights(count: int, like):
    """Equal weights for the enabled children when a modality is disabled."""
    n, d = like.shape
    return torch.ones((count, n, d), dtype=like.dtype, device=like.device)


@dataclasses.dataclass(frozen=True, eq=False)
class CrossmodalKFDef(FilterDef):
    """K per-modality virtual-sensor EKFs whose posteriors are mixed with
    learned per-state-dim weights. The fused belief is written back into
    every child: it is the one carry, and every child predicts from it."""

    filter_models: Tuple[VirtualSensorEKFDef, ...]
    crossmodal_weight_model: KFWeightDef
    state_dim: int
    know_image_blackout: bool = False
    stack_children: bool = True

    def module(self) -> nn.Module:
        return nn.ModuleDict({
            "filter_models": nn.ModuleDict({
                str(i): fm.module() for i, fm in enumerate(self.filter_models)}),
            "crossmodal_weight_model": self.crossmodal_weight_model.module(),
        })

    def initialize_beliefs(self, mean, covariance, *, train: bool,
                           generator: Optional[torch.Generator] = None, eps=None):
        del train, generator, eps
        return GaussianBelief(mean, covariance)

    def _gate_weights(self, observations):
        weights = self.crossmodal_weight_model.apply(observations)
        if self.know_image_blackout:
            weights = _blackout_override(weights, _blackout_mask(observations)[:, None])
        return weights

    def step(self, belief, observations, controls, *, train: bool,
             enabled: Optional[Tuple[bool, ...]] = None, eps=None, uniforms=None,
             generator: Optional[torch.Generator] = None):
        del eps, uniforms, generator
        enabled = _normalize_enabled(enabled, len(self.filter_models))
        with torch.set_grad_enabled(train):
            means, covs = [], []
            for i in _enabled_indices(enabled):
                child, mean = self.filter_models[i].step(belief, observations, controls,
                                                         train=train)
                means.append(mean)
                covs.append(child.cov)
            if all(enabled):
                weights = self._gate_weights(observations)
            else:
                weights = _indicator_weights(len(means), means[0])
            fused_mean, fused_cov = _calculate_weighted_states(
                weights, torch.stack(means), torch.stack(covs))
            return GaussianBelief(fused_mean, fused_cov), fused_mean

    def forward_loop(self, belief, observations_seq, controls_seq, *, train: bool,
                     enabled: Optional[Tuple[bool, ...]] = None, eps_seq=None,
                     uniforms_seq=None, generator: Optional[torch.Generator] = None):
        """The children's virtual sensors and control encoders and the gate
        run once over all T*N frames; the loop holds the K EKF updates and
        the weighted fusion. Returns (final belief, estimates (T, N, D))."""
        del eps_seq, uniforms_seq, generator
        enabled = _normalize_enabled(enabled, len(self.filter_models))
        idx = _enabled_indices(enabled)
        with torch.set_grad_enabled(train):
            t, n = controls_seq.shape[:2]
            virtuals = [self.filter_models[i].precompute_virtual(observations_seq)
                        for i in idx]
            ctrl_feats = [self.filter_models[i].precompute_control_features(controls_seq)
                          for i in idx]
            if all(enabled):
                flat = {k: v.reshape((t * n,) + v.shape[2:])
                        for k, v in observations_seq.items()}
                weights = self._gate_weights(flat)  # (K, T*N, D)
                weights_seq = weights.reshape(len(idx), t, n, -1).transpose(0, 1)
            else:
                weights_seq = None
            estimates = []
            for s in range(t):
                means, covs = [], []
                for j, i in enumerate(idx):
                    z_seq, r_seq = virtuals[j]
                    child, mean = self.filter_models[i].update_from_virtual(
                        belief, z_seq[s], r_seq[s], controls_seq[s],
                        ctrl_feat=None if ctrl_feats[j] is None else ctrl_feats[j][s],
                    )
                    means.append(mean)
                    covs.append(child.cov)
                weights = (weights_seq[s] if weights_seq is not None
                           else _indicator_weights(len(means), means[0]))
                fused_mean, fused_cov = _calculate_weighted_states(
                    weights, torch.stack(means), torch.stack(covs))
                belief = GaussianBelief(fused_mean, fused_cov)
                estimates.append(fused_mean)
            return belief, torch.stack(estimates)

    def measurement_initialize_beliefs(self, observations, *, train: bool = False,
                                       enabled: Optional[Tuple[bool, ...]] = None):
        """The belief of the enabled children's virtual sensors, mixed by the
        gate's own weights for them: no blackout override and no indicator
        weights, as in the JAX package."""
        del train
        enabled = _normalize_enabled(enabled, len(self.filter_models))
        idx = _enabled_indices(enabled)
        zs, covs = [], []
        for i in idx:
            z, tril = self.filter_models[i].virtual_sensor_model.apply(observations)
            zs.append(z)
            covs.append(tril @ tril.mT)
        weights = self.crossmodal_weight_model.apply(observations)
        weights = torch.stack([weights[i] for i in idx])
        mean = weighted_average(torch.stack(zs), weights)
        cov_multiplier = torch.prod(torch.prod(weights, dim=-1), dim=0)[:, None, None]
        return GaussianBelief(mean, cov_multiplier * torch.stack(covs).sum(dim=0))


def _precision_fusion(means, covs):
    """Product of Gaussians over the child axis 0, with the reference's
    scalar 1e-9 added to every entry before each matrix inverse."""
    precisions = inverse(covs + 1e-9)
    fused_cov = inverse(precisions.sum(dim=0) + 1e-9)
    weighted = torch.einsum("knij,knj->kni", precisions, means).sum(dim=0)
    return torch.einsum("nij,nj->ni", fused_cov, weighted)


@dataclasses.dataclass(frozen=True, eq=False)
class UnimodalKFDef(FilterDef):
    """K per-modality EKFs with INDEPENDENT beliefs (a tuple, one a child;
    no write-back), their estimates fused as a product of Gaussians. A
    disabled child's belief stays as it was."""

    filter_models: Tuple[VirtualSensorEKFDef, ...]
    state_dim: int
    stack_children: bool = True

    def module(self) -> nn.Module:
        return nn.ModuleDict({
            "filter_models": nn.ModuleDict({
                str(i): fm.module() for i, fm in enumerate(self.filter_models)}),
        })

    def initialize_beliefs(self, mean, covariance, *, train: bool,
                           generator: Optional[torch.Generator] = None, eps=None):
        del train, generator, eps
        return tuple(GaussianBelief(mean, covariance) for _ in self.filter_models)

    def measurement_initialize_beliefs(self, observations, *, train: bool = False,
                                       enabled: Optional[Tuple[bool, ...]] = None):
        """Each child from its own virtual sensor's (z, R). The reference's
        UnimodalKalmanFilter has none; this is the JAX package's."""
        del train, enabled
        return tuple(fm.measurement_initialize_beliefs(observations)
                     for fm in self.filter_models)

    @staticmethod
    def _fuse(means, covs):
        if len(means) == 1:
            return means[0]
        return _precision_fusion(torch.stack(means), torch.stack(covs))

    def step(self, belief, observations, controls, *, train: bool,
             enabled: Optional[Tuple[bool, ...]] = None, eps=None, uniforms=None,
             generator: Optional[torch.Generator] = None):
        del eps, uniforms, generator
        enabled = _normalize_enabled(enabled, len(self.filter_models))
        with torch.set_grad_enabled(train):
            beliefs, means, covs = list(belief), [], []
            for i in _enabled_indices(enabled):
                beliefs[i], mean = self.filter_models[i].step(
                    belief[i], observations, controls, train=train)
                means.append(mean)
                covs.append(beliefs[i].cov)
            return tuple(beliefs), self._fuse(means, covs)

    def forward_loop(self, belief, observations_seq, controls_seq, *, train: bool,
                     enabled: Optional[Tuple[bool, ...]] = None, eps_seq=None,
                     uniforms_seq=None, generator: Optional[torch.Generator] = None):
        """The children's virtual sensors and control encoders run once over
        all T*N frames; the loop holds K independent EKF updates and the
        precision fusion."""
        del eps_seq, uniforms_seq, generator
        enabled = _normalize_enabled(enabled, len(self.filter_models))
        idx = _enabled_indices(enabled)
        with torch.set_grad_enabled(train):
            virtuals = [self.filter_models[i].precompute_virtual(observations_seq)
                        for i in idx]
            ctrl_feats = [self.filter_models[i].precompute_control_features(controls_seq)
                          for i in idx]
            beliefs, estimates = list(belief), []
            for s in range(controls_seq.shape[0]):
                means, covs = [], []
                for j, i in enumerate(idx):
                    z_seq, r_seq = virtuals[j]
                    beliefs[i], mean = self.filter_models[i].update_from_virtual(
                        beliefs[i], z_seq[s], r_seq[s], controls_seq[s],
                        ctrl_feat=None if ctrl_feats[j] is None else ctrl_feats[j][s],
                    )
                    means.append(mean)
                    covs.append(beliefs[i].cov)
                estimates.append(self._fuse(means, covs))
            return tuple(beliefs), torch.stack(estimates)


# ---------------------------------------------------------------------------
# Virtual-sensor (measurement-level) fusion
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True, eq=False)
class CrossmodalVirtualSensorDef:
    """K virtual sensors fused by a gate into one virtual measurement for a
    single EKF. Returns (mean, cholesky(fused cov))."""

    virtual_sensor_model: Tuple  # VirtualSensorDefs (the reference's name)
    crossmodal_weight_model: KFWeightDef

    def module(self) -> nn.Module:
        return nn.ModuleDict({
            "virtual_sensor_model": nn.ModuleDict({
                str(i): vs.module() for i, vs in enumerate(self.virtual_sensor_model)}),
            "crossmodal_weight_model": self.crossmodal_weight_model.module(),
        })

    def apply(self, observations, enabled: Optional[Tuple[bool, ...]] = None):
        enabled = _normalize_enabled(enabled, len(self.virtual_sensor_model))
        zs, covs = [], []
        for i in _enabled_indices(enabled):
            z, tril = self.virtual_sensor_model[i].apply(observations)
            zs.append(z)
            covs.append(tril @ tril.mT)
        if all(enabled):
            weights = self.crossmodal_weight_model.apply(observations)
        else:
            weights = _indicator_weights(len(zs), zs[0])
        mean = weighted_average(torch.stack(zs), weights)
        cov_multiplier = torch.prod(torch.prod(weights, dim=-1), dim=0)[:, None, None]
        return mean, cholesky(cov_multiplier * torch.stack(covs).sum(dim=0))


@dataclasses.dataclass(frozen=True, eq=False)
class UnimodalVirtualSensorDef:
    """K virtual sensors fused by (elementwise-reciprocal) precision
    weighting. Returns a covariance, not a scale_tril, as its second value
    (the reference's literal return)."""

    virtual_sensor_model: Tuple  # VirtualSensorDefs

    def module(self) -> nn.Module:
        return nn.ModuleDict({
            "virtual_sensor_model": nn.ModuleDict({
                str(i): vs.module() for i, vs in enumerate(self.virtual_sensor_model)}),
        })

    def apply(self, observations, enabled: Optional[Tuple[bool, ...]] = None):
        enabled = _normalize_enabled(enabled, len(self.virtual_sensor_model))
        zs, trils = [], []
        for i in _enabled_indices(enabled):
            z, tril = self.virtual_sensor_model[i].apply(observations)
            zs.append(z)
            trils.append(tril)
        if len(zs) == 1:
            return zs[0], trils[0] @ trils[0].mT  # the covariance
        trils = torch.stack(trils)
        precisions = 1.0 / (trils + 1e-9)
        weights = torch.diagonal(precisions, dim1=-2, dim2=-1)  # (K, N, D)
        mean = weighted_average(torch.stack(zs), weights)
        return mean, inverse(precisions.sum(dim=0) + 1e-9)
