"""Particle resampling primitives (port of
``multimodalfilter_tpu/ops/resampling.py``): multinomial, systematic and
soft resampling by inverse CDF, from pre-drawn uniforms or a
``torch.Generator``.

These divide the CDF by its last entry, as the JAX plain path does; the B1
kernel (``ops/pf_kernels.py``) does not, so the two agree up to draws that
land on a CDF tie.
"""

from __future__ import annotations

import math
from typing import Optional

import torch


def _gather_particles(particles, indices):
    """particles (N, M, D), indices (N, M) -> (N, M, D)."""
    return torch.gather(
        particles, 1, indices[:, :, None].expand(-1, -1, particles.shape[2])
    )


def _uniforms(n, m, like, uniforms, generator):
    if uniforms is not None:
        return uniforms
    return torch.rand((n, m), generator=generator, device=like.device,
                      dtype=like.dtype)


def _sample_indices(cdf, uniforms):
    """Inverse-CDF search. `searchsorted` left side (first index with
    cdf >= u), as ``jnp.searchsorted``; clipped to M-1."""
    cdf = cdf / cdf[..., -1:]
    indices = torch.searchsorted(cdf, uniforms.contiguous(), right=False)
    return indices.clamp_(max=cdf.shape[-1] - 1)


def multinomial_resample(particles, log_weights, uniforms=None,
                         generator: Optional[torch.Generator] = None):
    """Standard multinomial resampling; returns uniform weights."""
    n, m, _ = particles.shape
    u = _uniforms(n, m, log_weights, uniforms, generator)
    indices = _sample_indices(torch.cumsum(torch.exp(log_weights), dim=-1), u)
    new_log_weights = torch.full((n, m), -math.log(m), dtype=log_weights.dtype,
                                 device=log_weights.device)
    return _gather_particles(particles, indices), new_log_weights


def systematic_resample(particles, log_weights, u0=None,
                        generator: Optional[torch.Generator] = None):
    """Systematic resampling: one uniform per row, ``u0`` (N, 1) given or
    drawn from `generator`, at the positions ``(u0 + j) / M``. Lower
    variance than multinomial; the indices come out sorted. Returns uniform
    weights."""
    n, m, _ = particles.shape
    if u0 is None:
        u0 = torch.rand((n, 1), generator=generator, device=log_weights.device,
                        dtype=log_weights.dtype)
    positions = (u0 + torch.arange(m, device=log_weights.device,
                                   dtype=log_weights.dtype)[None, :]) / m
    indices = _sample_indices(torch.cumsum(torch.exp(log_weights), dim=-1), positions)
    new_log_weights = torch.full((n, m), -math.log(m), dtype=log_weights.dtype,
                                 device=log_weights.device)
    return _gather_particles(particles, indices), new_log_weights


def soft_resample(particles, log_weights, alpha: float, uniforms=None,
                  generator: Optional[torch.Generator] = None):
    """Soft resampling: sample from ``alpha*w + (1-alpha)/M`` and reweight by
    the importance ratio, then log-normalise."""
    n, m, _ = particles.shape
    mixture = alpha * torch.exp(log_weights) + (1.0 - alpha) / m
    u = _uniforms(n, m, log_weights, uniforms, generator)
    indices = _sample_indices(torch.cumsum(mixture, dim=-1), u)
    new_log_weights = (
        torch.gather(log_weights, 1, indices)
        - torch.gather(torch.log(mixture), 1, indices)
    )
    new_log_weights = new_log_weights - torch.logsumexp(
        new_log_weights, dim=1, keepdim=True
    )
    return _gather_particles(particles, indices), new_log_weights
