"""Particle-axis sharding (port of
``multimodalfilter_tpu/parallel/particle_sharding.py``): the PF's M axis
split over a mesh axis, each rank holding an (N, M/Q, D) block.

Per step the dynamics and the measurement trunks are local. The weight
normalisation is global: a max all-reduce of detached values, then one sum
all-reduce that carries both the weight mass and the weighted particle sum,
so the estimate comes with it (in training its backward sums the
cotangent of the mass over the axis, since each rank's block reads the
mass). In eval the resampling is global systematic resampling: one all-gather of each block's particles and local
CDF gives every rank the global CDF (each block offset by the mass of the
blocks before it), and each rank draws its own M/Q output slots from the
stratified positions ``(u0 + slot) / M``. The offset u0 must be the same on
every rank of the axis: the loop takes it pre-drawn (``u0_seq``). In
training there is no resampling, and the dynamics noise is the rank's block
of the global draw, so estimates and gradients are those of the plain
``forward_loop(train=True)``.

This tail is collective, so B1, B4, B5 and B3 do not run inside it, as the
JAX package's sharded step bypasses its Pallas tail.

Outside autograd the collectives are the functional ones
(``collectives.py``), so the eval loop traces into a graph that export
saves. The one other thing that differs by rank is the block's place on
the axis, which sets its output slots: a traced loop takes it as a tensor
input (``block_index``), which a serving bundle feeds each rank.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from ..filtering.pf import _tree_map
from ..types import ParticleBelief
from . import collectives
from .mesh import axis_index, axis_size


def sharded_pf_step(defn, belief, log_lik_fn, controls, *, mesh, axis_name: str,
                    train: bool, eps, u0=None, ctrl_features=None, block_index=None):
    """One particle-sharded PF step. `belief` is this rank's block, its
    log-weights normalised over the whole axis; `eps` (N*Mp, D) the block's
    noise (row order n*Mp + j); `u0` (N,) the stratified offset, the same on
    every rank (eval); `block_index` the block's place on the axis (default:
    this rank's). Returns (block belief, estimate (N, D) replicated over the
    axis)."""
    particles, log_weights = belief
    n, mp, d = particles.shape
    shards = axis_size(mesh, axis_name)
    m = mp * shards

    flat = particles.reshape(n * mp, d)
    if ctrl_features is not None:
        pred, tril = defn.dynamics_model.apply_with_control_features(
            flat, ctrl_features.repeat_interleave(mp, dim=0))
    else:
        pred, tril = defn.dynamics_model.apply(flat, controls.repeat_interleave(mp, dim=0))
    particles = (pred + torch.einsum("bij,bj->bi", tril, eps)).reshape(n, mp, d)

    log_w = log_weights + log_lik_fn(particles)
    w_max = collectives.all_reduce_max(log_w.amax(dim=1), mesh, axis_name)  # (N,)
    shifted = torch.exp(log_w - w_max[:, None])
    # The mass's sum normalises this rank's block too, work that differs by
    # rank: its cotangent is summed over the axis in the backward.
    sums, block_sums = collectives.all_reduce_sum_split(
        torch.cat([shifted.sum(dim=1, keepdim=True),
                   torch.einsum("nm,nmd->nd", shifted, particles)], dim=1),
        mesh, axis_name)
    estimate = sums[:, 1:] / sums[:, :1]
    log_w = log_w - w_max[:, None] - torch.log(block_sums[:, :1])
    if train:  # no resampling: BPTT keeps the weight recursion
        return ParticleBelief(particles, log_w), estimate
    return systematic_resample_blocks(particles, log_w, u0, mesh, axis_name,
                                      block_index=block_index), estimate


def systematic_resample_blocks(particles, log_w, u0, mesh, axis_name: str,
                               block_index=None) -> ParticleBelief:
    """Global systematic resampling of particle blocks: `particles` (N, Mp,
    D) and `log_w` (N, Mp), this rank's block, normalised over the axis;
    `u0` (N,) the same on every rank; `block_index` the block's place on
    the axis, an int or a 0-dim tensor (default: this rank's). Returns the
    block's Mp output slots and their log-weights, -log M."""
    n, mp, d = particles.shape
    shards = axis_size(mesh, axis_name)
    m = mp * shards
    local_cdf = torch.cumsum(torch.exp(log_w), dim=1)
    gathered = collectives.all_gather(
        torch.cat([particles, local_cdf[..., None]], dim=-1), mesh, axis_name, dim=1)
    all_particles = gathered[..., :d]
    cdfs = gathered[..., d].reshape(n, shards, mp)
    masses = cdfs[:, :, -1]
    offsets = torch.cumsum(masses, dim=1) - masses  # the mass of the blocks before
    all_cdf = (cdfs + offsets[..., None]).reshape(n, m)
    all_cdf = all_cdf / all_cdf[:, -1:]
    if block_index is None:
        block_index = axis_index(mesh, axis_name)
    slots = block_index * mp + torch.arange(mp, device=particles.device,
                                            dtype=particles.dtype)
    positions = (u0[:, None] + slots[None, :]) / m
    idx = torch.searchsorted(all_cdf, positions.contiguous()).clamp_(max=m - 1)
    particles = torch.take_along_dim(all_particles, idx[..., None], dim=1)
    log_w = torch.full((n, mp), -math.log(m), dtype=particles.dtype,
                       device=particles.device)
    return ParticleBelief(particles, log_w)


def particle_sharded_loop(defn, mesh, belief, observations_seq, controls_seq, *,
                          train: bool, eps_seq, u0_seq=None,
                          enabled: Optional[Tuple[bool, ...]] = None,
                          axis_name: str = "particle", block_index=None):
    """The PF ``forward_loop`` over this rank's particle block. `belief`:
    (N, M/Q, D) particles and their globally normalised log-weights;
    observations (T, N, ...) and controls (T, N, C), whole; `eps_seq` (T,
    N*M/Q, D), the block's noise; `u0_seq` (T, N) in eval, the same on
    every rank; `block_index` as ``systematic_resample_blocks`` takes it.
    The encoders run over all T*N frames first, on every rank of the axis
    (as in the JAX package). Returns (block belief, estimates (T, N, D))."""
    with torch.set_grad_enabled(train):
        t = controls_seq.shape[0]
        features_seq, ctrl_feat_seq = defn.encode_sequences(
            observations_seq, controls_seq, enabled=enabled)
        if not train and u0_seq is None:
            raise ValueError("the particle-sharded eval loop needs u0_seq")
        estimates = []
        for i in range(t):
            features_t = _tree_map(lambda v, i=i: v[i], features_seq)
            belief, estimate = sharded_pf_step(
                defn, belief,
                lambda p, f=features_t: defn.measurement_model.log_likelihoods_from_features(
                    p, f, enabled=enabled),
                controls_seq[i], mesh=mesh, axis_name=axis_name, train=train,
                eps=eps_seq[i], u0=None if train else u0_seq[i],
                ctrl_features=None if ctrl_feat_seq is None else ctrl_feat_seq[i],
                block_index=block_index,
            )
            estimates.append(estimate)
        return belief, torch.stack(estimates)
