"""Particle filter (port of ``multimodalfilter_tpu/filtering/pf.py``):

  propagate particles through dynamics (+ Gaussian noise from scale_tril)
  -> per-particle measurement log-likelihoods
  -> weight update + log-normalise
  -> weighted-mean estimate (before resampling)
  -> (eval only) multinomial resample / (alpha < 1) soft resample

The particle axis M is fused with batch N into one (N*M, ...) batch for the
dynamics network. ``forward_loop`` always hoists the observation encoders
and the control encoder over all T*N frames and pre-draws the noise and
uniforms. The step tail is chosen by device: for CUDA tensors, in eval, B1
(multinomial), B4 (soft) or B5 (M > 1024) (``ops/pf_kernels.py``), in train
the B2 kernels, forward and backward (``ops/pf_estimate.py``); their plain
versions for CPU tensors. With ``fused_step`` the eval ``forward_loop`` runs
as one kernel, B3 (``ops/fused_step.py``), when the config qualifies.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
from torch import nn

from ..ops import custom_ops
from ..ops import fused_step as _fused
from ..ops.pf_estimate import pf_update_estimate, pf_update_estimate_reference
from ..ops.pf_kernels import SMALL_M_MAX, pf_update_and_resample
from ..ops.resampling import multinomial_resample, soft_resample
from ..types import ParticleBelief
from ..utils.debug import (
    SPAN_PF_DYNAMICS,
    SPAN_PF_ENCODE,
    SPAN_PF_MEASUREMENT,
    SPAN_PF_STEP,
    SPAN_PF_TAIL,
    span,
)
from .base import DynamicsDef, FilterDef


def _tree_map(fn, x):
    """`fn` over a tensor or over the values of a dict of tensors
    (observations and features are either)."""
    return {k: fn(v) for k, v in x.items()} if isinstance(x, dict) else fn(x)


@dataclasses.dataclass(frozen=True, eq=False)
class ParticleFilterDef(FilterDef):
    dynamics_model: DynamicsDef
    measurement_model: object  # MeasurementDef or CrossmodalPFMeasurementDef
    state_dim: int
    num_particles_train: int = 30
    num_particles_eval: int = 300
    soft_resample_alpha: float = 1.0
    # Run the whole eval forward_loop as one kernel, B3 (ops/fused_step.py):
    # the small-N serving route (MMF_TPU_FUSED_STEP=1, with_fused_step). The
    # JAX route also needs pallas_resample; the port has no such field, since
    # it picks kernels by device, so this field alone selects the route. On
    # CUDA it launches B3 or raises; on the CPU it runs B3's plain version. A
    # config B3 does not cover (soft resampling, M > 512, units != 64,
    # non-diagonal noise, ...) takes the per-step path, with the reason in
    # ops.fused_step.packing_report() and one warning. Same recursion, sums
    # in another order: tie-level resampling draws can differ.
    fused_step: bool = False

    def num_particles(self, train: bool) -> int:
        return self.num_particles_train if train else self.num_particles_eval

    def module(self) -> nn.Module:
        return nn.ModuleDict({
            "dynamics_model": self.dynamics_model.module(),
            "measurement_model": self.measurement_model.module(),
        })

    def initialize_beliefs(self, mean, covariance, *, train: bool,
                           generator: Optional[torch.Generator] = None, eps=None):
        """Sample particles ~ N(mean, covariance); uniform log-weights.
        `eps` (N, M, D) may be pre-drawn; otherwise it is drawn from
        `generator`."""
        n, d = mean.shape
        m = self.num_particles(train)
        chol = torch.linalg.cholesky(covariance)
        if eps is None:
            eps = torch.randn((n, m, d), generator=generator, dtype=mean.dtype,
                              device=mean.device)
        elif tuple(eps.shape) != (n, m, d):
            raise ValueError(f"eps must be {(n, m, d)}, got {tuple(eps.shape)}")
        particles = mean[:, None, :] + torch.einsum("nij,nmj->nmi", chol, eps)
        log_weights = torch.full((n, m), -math.log(m), dtype=mean.dtype,
                                 device=mean.device)
        return ParticleBelief(particles, log_weights)

    def _step_core(self, belief, log_lik_fn, controls, *, train: bool,
                   eps=None, uniforms=None, ctrl_features=None, generator=None):
        """One PF timestep given a log-likelihood closure over the propagated
        particles. `eps` (N*M, D) and `uniforms` (N, M) may be pre-drawn;
        otherwise they are drawn from `generator`."""
        with span(SPAN_PF_STEP):
            particles, log_weights = belief
            n, m, d = particles.shape

            # --- Dynamics propagation (N and M flattened; row order n*M + j) ---
            with span(SPAN_PF_DYNAMICS):
                flat_particles = particles.reshape(n * m, d)
                if ctrl_features is not None:
                    # (N, U) -> (N*M, U), each row repeated M times in place, as
                    # jnp.repeat(axis=0) does (Tensor.repeat would tile instead).
                    pred_mean, scale_tril = self.dynamics_model.apply_with_control_features(
                        flat_particles, ctrl_features.repeat_interleave(m, dim=0)
                    )
                else:
                    pred_mean, scale_tril = self.dynamics_model.apply(
                        flat_particles, controls.repeat_interleave(m, dim=0)
                    )
                if eps is None:
                    eps = torch.randn(pred_mean.shape, generator=generator,
                                      dtype=pred_mean.dtype, device=pred_mean.device)
                particles = (
                    pred_mean + torch.einsum("bij,bj->bi", scale_tril, eps)
                ).reshape(n, m, d)

            # --- Measurement update ---
            with span(SPAN_PF_MEASUREMENT):
                log_liks = log_lik_fn(particles)

            with span(SPAN_PF_TAIL):
                return self._step_tail(particles, log_weights, log_liks, train=train,
                                       uniforms=uniforms, generator=generator)

    def _step_tail(self, particles, log_weights, log_liks, *, train: bool, uniforms,
                   generator):
        """The weight update, estimate and (eval) resample of a step."""
        n, m, _ = particles.shape
        if train:
            # Update and estimate, no resampling during BPTT: the B2 kernels
            # (forward and backward) on CUDA, their plain version on the CPU.
            log_weights, estimate = pf_update_estimate(
                log_weights.contiguous(), log_liks.contiguous(),
                particles.contiguous(),
            )
            return ParticleBelief(particles, log_weights), estimate

        if uniforms is None:
            uniforms = torch.rand((n, m), generator=generator,
                                  dtype=particles.dtype, device=particles.device)
        # On CUDA one of B1, B4, B5 by alpha and M; on the CPU B1's plain
        # version. Under a tracer through the op, which the traced program
        # keeps (ops/custom_ops.py).
        if particles.is_cuda or (self.soft_resample_alpha >= 1.0 and m <= SMALL_M_MAX):
            tail = custom_ops.pf_tail if custom_ops.tracing() else pf_update_and_resample
            particles, log_weights, estimate = tail(
                log_weights.contiguous(), log_liks.contiguous(),
                particles.contiguous(), uniforms.contiguous(),
                alpha=self.soft_resample_alpha,
            )
            return ParticleBelief(particles, log_weights), estimate

        # CPU only (soft resampling, or M > SMALL_M_MAX): the plain update,
        # the estimate taken before resampling, then the resample.
        log_weights, estimate = pf_update_estimate_reference(
            log_weights, log_liks, particles
        )
        if self.soft_resample_alpha >= 1.0:
            particles, log_weights = multinomial_resample(
                particles, log_weights, uniforms=uniforms
            )
        else:
            particles, log_weights = soft_resample(
                particles, log_weights, self.soft_resample_alpha, uniforms=uniforms,
            )
        return ParticleBelief(particles, log_weights), estimate

    def step(self, belief, observations, controls, *, train: bool,
             enabled: Optional[Tuple[bool, ...]] = None, eps=None,
             uniforms=None, generator: Optional[torch.Generator] = None):
        with torch.set_grad_enabled(train):
            return self._step_core(
                belief,
                lambda particles: self.measurement_model.log_likelihoods(
                    particles, observations, enabled=enabled
                ),
                controls, train=train, eps=eps, uniforms=uniforms,
                generator=generator,
            )

    def encode_sequences(self, observations_seq, controls_seq,
                         enabled: Optional[Tuple[bool, ...]] = None):
        """``forward_loop``'s hoisted, carry-independent inputs: the
        observation features (T, N, ...) of the enabled modalities (and the
        gate's log-weights) and the control features (T, N, U), or None when
        the dynamics net does not split."""
        t, n = controls_seq.shape[:2]
        with span(SPAN_PF_ENCODE):
            flat_obs = _tree_map(lambda v: v.reshape((t * n,) + v.shape[2:]),
                                 observations_seq)
            features = self.measurement_model.encode_observations(flat_obs, enabled=enabled)
            features_seq = _tree_map(lambda v: v.reshape((t, n) + v.shape[1:]), features)
            ctrl_feat_seq = None
            if self.dynamics_model.supports_control_hoist:
                ctrl_feat = self.dynamics_model.encode_controls(
                    controls_seq.reshape((t * n,) + controls_seq.shape[2:])
                )
                ctrl_feat_seq = ctrl_feat.reshape((t, n) + ctrl_feat.shape[1:])
        return features_seq, ctrl_feat_seq

    def forward_loop(self, belief, observations_seq, controls_seq, *,
                     train: bool, enabled: Optional[Tuple[bool, ...]] = None,
                     eps_seq=None, uniforms_seq=None,
                     generator: Optional[torch.Generator] = None):
        """Unroll over the leading time axis. observations_seq: dict of
        (T, N, ...); controls_seq: (T, N, C). `eps_seq` (T, N*M, D) and, in
        eval, `uniforms_seq` (T, N, M) are drawn from `generator` before the
        loop when not given. Returns (final_belief, estimates (T, N, D)).

        The observation encoders (where the FLOPs are) and the control
        encoder are carry-independent, so they run once over all T*N frames
        before the loop. With ``fused_step`` (eval) the loop is one kernel,
        B3, when the config qualifies."""
        with torch.set_grad_enabled(train):
            t, n = controls_seq.shape[:2]
            m = belief.particles.shape[1]
            d = self.state_dim
            device, dtype = belief.particles.device, belief.particles.dtype

            features_seq, ctrl_feat_seq = self.encode_sequences(
                observations_seq, controls_seq, enabled=enabled
            )
            if eps_seq is None:
                eps_seq = torch.randn((t, n * m, d), generator=generator,
                                      dtype=dtype, device=device)
            if uniforms_seq is None and not train:
                uniforms_seq = torch.rand((t, n, m), generator=generator,
                                          dtype=dtype, device=device)
            if tuple(eps_seq.shape) != (t, n * m, d):
                raise ValueError(f"eps_seq must be {(t, n * m, d)}, "
                                 f"got {tuple(eps_seq.shape)}")
            if not train and tuple(uniforms_seq.shape) != (t, n, m):
                raise ValueError(f"uniforms_seq must be {(t, n, m)}, "
                                 f"got {tuple(uniforms_seq.shape)}")

            if self.fused_step and not train:
                out = _fused.try_fused_forward(
                    self, belief, features_seq, ctrl_feat_seq, eps_seq, uniforms_seq,
                    enabled, run=custom_ops.fused_forward_op if custom_ops.tracing() else None)
                if out is not None:
                    return out

            estimates = []
            for i in range(t):
                features_t = _tree_map(lambda v, i=i: v[i], features_seq)
                belief, estimate = self._step_core(
                    belief,
                    lambda particles, f=features_t: (
                        self.measurement_model.log_likelihoods_from_features(
                            particles, f, enabled=enabled
                        )
                    ),
                    controls_seq[i], train=train, eps=eps_seq[i],
                    uniforms=None if train else uniforms_seq[i],
                    ctrl_features=None if ctrl_feat_seq is None else ctrl_feat_seq[i],
                )
                estimates.append(estimate)
            return belief, torch.stack(estimates)
