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

Two execution transforms, each a field with the JAX package's default:

  * ``stack_image_encoders`` (off; ``MMF_TPU_STACK_ENC=1``): the image
    encoders that read the same frame (a measurement model or virtual sensor
    and the gate) run as one stacked pass (``models/stacked.py``), and each
    consumer reads its slice as ``"_image_features"``;
  * ``stack_children`` (on) in the KF defs' ``step`` and ``forward_loop``:
    the enabled children's EKF updates run as one chain vmapped over a child
    axis (``torch.func.vmap`` of ``functional_call`` over the children's
    dynamics parameters stacked), in place of a loop over the children,
    where their dynamics share one architecture (``_dynamics_signature``);
    otherwise the loop. (The JAX package stacks in ``forward_loop`` only;
    the port's ``step`` runs the same chain as its loop.)
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch
from torch import nn
from torch.func import vmap

from ..models.stacked import encoder_stack_config, image_encoder, stacked_image_features
from ..types import GaussianBelief
from .base import FilterDef, encoder_options
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


def _stacked_image_injection(participants, observations):
    """Run the image encoders of `participants` ((pid, sub-def) pairs, each
    sub-def holding a ``net`` and its serving options) as one stacked pass
    over the shared frames. Returns {pid: observations with the pid's
    "_image_features"} for the participants that stack, or None when fewer
    than two share one encoder configuration (mixed configurations fall back
    to the per-instance encoders, as in the JAX package)."""
    stackable = []
    for pid, sub in participants:
        net = getattr(sub, "net", None)
        config = None if net is None else encoder_stack_config(
            net, getattr(sub, "dtype", None), getattr(sub, "fold_tail", False))
        if config is not None:
            stackable.append((pid, net, config))
    if len(stackable) < 2 or len({c for _, _, c in stackable}) != 1:
        return None
    _, _, dtype, fold_tail = stackable[0][2]
    feats = stacked_image_features([image_encoder(net) for _, net, _ in stackable],
                                   observations["image"], dtype=dtype, fold_tail=fold_tail)
    return {pid: {**observations, "_image_features": f}
            for (pid, _, _), f in zip(stackable, feats)}


@dataclasses.dataclass(frozen=True, eq=False)
class PFWeightDef:
    """Gate over observations -> (N, K) log-weights; optional image-blackout
    override on modality 0."""

    net: nn.Module  # PFWeightNet
    know_image_blackout: bool = False
    dtype: Any = None  # the observation encoders' compute dtype
    fold_tail: bool = False  # the image encoder's folded tail

    def module(self) -> nn.Module:
        return self.net

    def log_weights(self, observations):
        out = self.net(observations, **encoder_options(self))
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
    # Stack the enabled models' image encoders with the gate's
    # (MMF_TPU_STACK_ENC=1, with_stacked_encoders).
    stack_image_encoders: bool = False

    def _stack_injection(self, observations, enabled):
        if not self.stack_image_encoders:
            return None
        parts = [(str(i), mm) for i, mm in enumerate(self.measurement_models) if enabled[i]]
        if self.crossmodal_weight_model is not None:
            parts.append(("_gate", self.crossmodal_weight_model))
        return _stacked_image_injection(parts, observations)

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
        if self.stack_image_encoders:
            # The stacked pass lives in encode_observations.
            return self.log_likelihoods_from_features(
                states, self.encode_observations(observations, enabled), enabled)
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
        inj = self._stack_injection(observations, enabled) or {}
        features = {
            str(i): mm.encode_observations(inj.get(str(i), observations))
            for i, mm in enumerate(self.measurement_models) if enabled[i]
        }
        if self.crossmodal_weight_model is not None:
            features["_log_weights"] = self.crossmodal_weight_model.log_weights(
                inj.get("_gate", observations)
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
    dtype: Any = None  # the observation encoders' compute dtype
    fold_tail: bool = False  # the image encoder's folded tail

    def module(self) -> nn.Module:
        return self.net

    def apply(self, observations):
        return self.net(observations, **encoder_options(self))


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


def _dynamics_signature(fm) -> tuple:
    """What two children's dynamics must share to run as one vmapped chain:
    the architecture (net type, state dim, units, process noise, parameter
    shapes) and ``hoist_ctrl``. The JAX package compares the dynamics defs,
    whose flax nets are configuration; the port's defs hold distinct
    modules, so equality is decided by architecture, never by identity."""
    net = fm.dynamics_model.net
    return (type(fm), type(net), getattr(net, "state_dim", None),
            getattr(net, "units", None), getattr(net, "q_scale_tril_diag", None),
            tuple((name, tuple(p.shape)) for name, p in net.named_parameters()),
            fm.hoist_ctrl)


def _stackable_children(defn, idx) -> bool:
    if not defn.stack_children or len(idx) < 2:
        return False
    first = _dynamics_signature(defn.filter_models[idx[0]])
    return all(_dynamics_signature(defn.filter_models[i]) == first for i in idx[1:])


def _stacked_dynamics_params(children):
    """The children's dynamics parameters stacked on a leading child axis,
    as ``torch.func.stack_module_state`` stacks them but without its detach:
    the stack is differentiable, so BPTT reaches every child's parameters."""
    per_child = [dict(fm.dynamics_model.net.named_parameters()) for fm in children]
    return {name: torch.stack([p[name] for p in per_child]) for name in per_child[0]}


def _vmapped_children(children, hoisted: bool, belief_dim):
    """fn(stacked params, z (K, N, D), r (K, N, D, D), dynamics input, mean,
    cov) -> the children's new (means (K, N, D), covs (K, N, D, D)): one EKF
    update vmapped over the child axis. The dynamics input is hoisted
    control features (K, N, U) or, unbatched, the controls (N, C); the
    belief is batched over the children (`belief_dim` 0) or shared by them
    (None). F's vmap(jacrev) runs inside."""
    fm0 = children[0]

    def one_child(params, z, r, dyn_in, mean, cov):
        child, _ = fm0.update_from_virtual(
            GaussianBelief(mean, cov), z, r, None if hoisted else dyn_in,
            ctrl_feat=dyn_in if hoisted else None, dynamics_params=params)
        return child.mean, child.cov

    return vmap(one_child, in_dims=(0, 0, 0, 0 if hoisted else None, belief_dim, belief_dim))


def _stacked_inputs(virtuals, ctrl_feats, controls_seq):
    """(z (T, K, N, D), r (T, K, N, D, D), the per-step dynamics input
    (T, K, N, U) of hoisted control features or (T, N, C) controls, and
    whether it is hoisted)."""
    z_st = torch.stack([z for z, _ in virtuals], dim=1)
    r_st = torch.stack([r for _, r in virtuals], dim=1)
    if all(cf is not None for cf in ctrl_feats):
        return z_st, r_st, torch.stack(ctrl_feats, dim=1), True
    return z_st, r_st, controls_seq, False


@dataclasses.dataclass(frozen=True, eq=False)
class CrossmodalKFDef(FilterDef):
    """K per-modality virtual-sensor EKFs whose posteriors are mixed with
    learned per-state-dim weights. The fused belief is written back into
    every child: it is the one carry, and every child predicts from it."""

    filter_models: Tuple[VirtualSensorEKFDef, ...]
    crossmodal_weight_model: KFWeightDef
    state_dim: int
    know_image_blackout: bool = False
    # Stack the image child's virtual-sensor encoder with the gate's
    # (MMF_TPU_STACK_ENC=1, with_stacked_encoders).
    stack_image_encoders: bool = False
    # step and forward_loop: the enabled children's EKF updates as one vmapped chain
    # (the fused carry broadcast into every child), where their dynamics
    # share an architecture; the loop over the children otherwise.
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

    def _stack_injection(self, observations, enabled, include_gate: bool):
        if not self.stack_image_encoders:
            return None
        parts = [(str(i), fm.virtual_sensor_model)
                 for i, fm in enumerate(self.filter_models) if enabled[i]]
        if include_gate:
            parts.append(("_gate", self.crossmodal_weight_model))
        return _stacked_image_injection(parts, observations)

    def _gate_weights(self, observations, gate_observations=None):
        weights = self.crossmodal_weight_model.apply(
            observations if gate_observations is None else gate_observations)
        if self.know_image_blackout:
            weights = _blackout_override(weights, _blackout_mask(observations)[:, None])
        return weights

    def step(self, belief, observations, controls, *, train: bool,
             enabled: Optional[Tuple[bool, ...]] = None, eps=None, uniforms=None,
             generator: Optional[torch.Generator] = None):
        del eps, uniforms, generator
        enabled = _normalize_enabled(enabled, len(self.filter_models))
        idx = _enabled_indices(enabled)
        with torch.set_grad_enabled(train):
            inj = self._stack_injection(observations, enabled, all(enabled)) or {}
            if _stackable_children(self, idx):
                children = [self.filter_models[i] for i in idx]
                zs, rs = zip(*(fm.virtual_sensor_model.apply(inj.get(str(i), observations))
                               for i, fm in zip(idx, children)))
                means, covs = _vmapped_children(children, False, None)(
                    _stacked_dynamics_params(children), torch.stack(zs), torch.stack(rs),
                    controls, *belief)
            else:
                means, covs = [], []
                for i in idx:
                    child, mean = self.filter_models[i].step(
                        belief, inj.get(str(i), observations), controls, train=train)
                    means.append(mean)
                    covs.append(child.cov)
                means, covs = torch.stack(means), torch.stack(covs)
            if all(enabled):
                weights = self._gate_weights(observations, inj.get("_gate"))
            else:
                weights = _indicator_weights(len(idx), means[0])
            fused_mean, fused_cov = _calculate_weighted_states(weights, means, covs)
            return GaussianBelief(fused_mean, fused_cov), fused_mean

    def forward_loop(self, belief, observations_seq, controls_seq, *, train: bool,
                     enabled: Optional[Tuple[bool, ...]] = None, eps_seq=None,
                     uniforms_seq=None, generator: Optional[torch.Generator] = None):
        """The children's virtual sensors and control encoders and the gate
        run once over all T*N frames (their image encoders stacked with
        ``stack_image_encoders``); the loop holds the K EKF updates (one
        vmapped chain with ``stack_children``) and the weighted fusion.
        Returns (final belief, estimates (T, N, D))."""
        del eps_seq, uniforms_seq, generator
        enabled = _normalize_enabled(enabled, len(self.filter_models))
        idx = _enabled_indices(enabled)
        with torch.set_grad_enabled(train):
            t, n = controls_seq.shape[:2]
            flat = {k: v.reshape((t * n,) + v.shape[2:])
                    for k, v in observations_seq.items()}
            inj = (self._stack_injection(flat, enabled, True) if all(enabled)
                   else None) or {}
            virtuals = []
            for i in idx:
                obs_i = observations_seq
                if str(i) in inj:
                    feat = inj[str(i)]["_image_features"]
                    obs_i = {**observations_seq,
                             "_image_features": feat.reshape((t, n) + feat.shape[1:])}
                virtuals.append(self.filter_models[i].precompute_virtual(obs_i))
            ctrl_feats = [self.filter_models[i].precompute_control_features(controls_seq)
                          for i in idx]
            if all(enabled):
                weights = self._gate_weights(flat, inj.get("_gate"))  # (K, T*N, D)
                weights_seq = weights.reshape(len(idx), t, n, -1).transpose(0, 1)
            else:
                weights_seq = None
            if _stackable_children(self, idx):
                return self._stacked_loop(belief, idx, virtuals, ctrl_feats,
                                          controls_seq, weights_seq)
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

    def _stacked_loop(self, belief, idx, virtuals, ctrl_feats, controls_seq, weights_seq):
        """forward_loop's steps with the children as one vmapped chain (JAX
        fusion.py:501-575): the fused belief enters every child unbatched."""
        children = [self.filter_models[i] for i in idx]
        params = _stacked_dynamics_params(children)
        z_st, r_st, dyn_in, hoisted = _stacked_inputs(virtuals, ctrl_feats, controls_seq)
        update = _vmapped_children(children, hoisted, None)
        estimates = []
        for s in range(controls_seq.shape[0]):
            means, covs = update(params, z_st[s], r_st[s], dyn_in[s], *belief)
            weights = (weights_seq[s] if weights_seq is not None
                       else _indicator_weights(len(idx), means[0]))
            fused_mean, fused_cov = _calculate_weighted_states(weights, means, covs)
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
    # step and forward_loop: the enabled children's EKF updates as one vmapped chain
    # over their stacked beliefs, where their dynamics share an architecture.
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
        idx = _enabled_indices(enabled)
        with torch.set_grad_enabled(train):
            beliefs, means, covs = list(belief), [], []
            if _stackable_children(self, idx):
                children = [self.filter_models[i] for i in idx]
                zs, rs = zip(*(fm.virtual_sensor_model.apply(observations)
                               for fm in children))
                mean_st, cov_st = _vmapped_children(children, False, 0)(
                    _stacked_dynamics_params(children), torch.stack(zs), torch.stack(rs),
                    controls, torch.stack([belief[i].mean for i in idx]),
                    torch.stack([belief[i].cov for i in idx]))
                for j, i in enumerate(idx):
                    beliefs[i] = GaussianBelief(mean_st[j], cov_st[j])
                return tuple(beliefs), _precision_fusion(mean_st, cov_st)
            for i in idx:
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
            if _stackable_children(self, idx):
                return self._stacked_loop(belief, idx, virtuals, ctrl_feats, controls_seq)
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

    def _stacked_loop(self, belief, idx, virtuals, ctrl_feats, controls_seq):
        """forward_loop's steps with the children as one vmapped chain over
        their beliefs stacked on a child axis (JAX fusion.py:762-842)."""
        children = [self.filter_models[i] for i in idx]
        params = _stacked_dynamics_params(children)
        z_st, r_st, dyn_in, hoisted = _stacked_inputs(virtuals, ctrl_feats, controls_seq)
        update = _vmapped_children(children, hoisted, 0)
        mean_st = torch.stack([belief[i].mean for i in idx])
        cov_st = torch.stack([belief[i].cov for i in idx])
        estimates = []
        for s in range(controls_seq.shape[0]):
            mean_st, cov_st = update(params, z_st[s], r_st[s], dyn_in[s], mean_st, cov_st)
            estimates.append(_precision_fusion(mean_st, cov_st))
        beliefs = list(belief)
        for j, i in enumerate(idx):
            beliefs[i] = GaussianBelief(mean_st[j], cov_st[j])
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
    # Stack the image virtual sensor's encoder with the gate's
    # (MMF_TPU_STACK_ENC=1, with_stacked_encoders).
    stack_image_encoders: bool = False

    def module(self) -> nn.Module:
        return nn.ModuleDict({
            "virtual_sensor_model": nn.ModuleDict({
                str(i): vs.module() for i, vs in enumerate(self.virtual_sensor_model)}),
            "crossmodal_weight_model": self.crossmodal_weight_model.module(),
        })

    def apply(self, observations, enabled: Optional[Tuple[bool, ...]] = None):
        enabled = _normalize_enabled(enabled, len(self.virtual_sensor_model))
        inj = None
        if self.stack_image_encoders and all(enabled):
            inj = _stacked_image_injection(
                [(str(i), vs) for i, vs in enumerate(self.virtual_sensor_model)]
                + [("_gate", self.crossmodal_weight_model)], observations)
        inj = inj or {}
        zs, covs = [], []
        for i in _enabled_indices(enabled):
            z, tril = self.virtual_sensor_model[i].apply(inj.get(str(i), observations))
            zs.append(z)
            covs.append(tril @ tril.mT)
        if all(enabled):
            weights = self.crossmodal_weight_model.apply(inj.get("_gate", observations))
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
