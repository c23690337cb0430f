"""Temporal pipeline parallelism (port of
``multimodalfilter_tpu/parallel/temporal_pipeline.py``): the filter's time
axis split over a mesh axis of P stages.

Stage s owns the time chunk [s*T/P, (s+1)*T/P). The trajectory batch splits
into `micro` microbatches, which the stages relay in the GPipe schedule of
``P + micro - 1`` steps (``parallel/schedule.py``): stage s runs microbatch
``step - s``. The last stage holds the final belief and broadcasts it; each
stage holds the estimates of its chunk, and an all-gather assembles (T, N,
D) on every rank.

A stage runs its chunk with the def's own ``forward_loop`` on the
microbatch (the encoders hoisted over the chunk, the PF tail through B1,
B4 or B5 on CUDA, B2 in training), or, with a particle axis, with the
particle-sharded loop. The fused route (B3) is not taken inside a stage, as
in the JAX package. The noise is the global draw: each stage takes its time
chunk and each microbatch's rows of the pre-drawn ``eps_seq`` and
``uniforms_seq`` (per row already, where JAX folds per-step keys), so the
pipelined loop computes what the plain loop computes for any `micro`.

In training the relay is differentiable (``collectives.send_next`` and
``recv_prev``): BPTT through a pipelined rollout sends each microbatch's
belief cotangent back to the stage before.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch.utils import _pytree as pytree

from ..filtering.pf import ParticleFilterDef, _tree_map
from ..utils.precision import with_fused_step
from .mesh import axis_index, axis_size
from .particle_sharding import particle_sharded_loop
from .schedule import run_schedule


def _rows(x, rows: slice):
    return _tree_map(lambda v: v[:, rows], x)


def pipelined_loop(defn, mesh, belief, observations_seq, controls_seq, *, train: bool,
                   enabled: Optional[Tuple[bool, ...]] = None, eps_seq=None,
                   uniforms_seq=None, axis_name: str = "pipe", num_microbatches: int = 1,
                   particle_axis_name: Optional[str] = None):
    """``forward_loop`` with the time axis over `mesh`'s `axis_name`.

    `belief` (batch on axis 0 of every leaf), observations (T, N, ...) and
    controls (T, N, C) are this rank's rows, T whole and divisible by the
    stage count; a PF's `eps_seq` (T, N*M, D) and `uniforms_seq` (T, N, M)
    likewise, or with `particle_axis_name` the rank's particle block: an
    (N, M/Q, D) belief, `eps_seq` (T, N*M/Q, D) and the stratified offsets
    `uniforms_seq` (T, N). Returns (final belief, the same on every stage;
    in training this rank's, which the loss does not read) and estimates
    (T, N, D), differentiable in training."""
    stages = axis_size(mesh, axis_name)
    stage = axis_index(mesh, axis_name)
    micro = num_microbatches
    t, n = controls_seq.shape[:2]
    if t % stages:
        raise ValueError(f"T={t} does not divide over {stages} pipeline stages")
    t_loc = t // stages
    span = slice(stage * t_loc, (stage + 1) * t_loc)
    obs_c = _tree_map(lambda v: v[span], observations_seq)
    ctrl_c = controls_seq[span]
    is_pf = isinstance(defn, ParticleFilterDef)
    if is_pf:
        # Per-step chunks, as the JAX pipeline runs them: no fused route.
        defn = with_fused_step(defn, False)
        eps_c = eps_seq[span].reshape(t_loc, n, -1, eps_seq.shape[-1])
        uni_c = None if train else uniforms_seq[span]

    def run_chunk(belief_in, rows: slice):
        if not is_pf:
            return defn.forward_loop(belief_in, _rows(obs_c, rows), ctrl_c[:, rows],
                                     train=train, enabled=enabled)
        eps_mb = eps_c[:, rows].reshape(t_loc, -1, eps_c.shape[-1])
        uni_mb = None if train else uni_c[:, rows]
        if particle_axis_name is not None:
            return particle_sharded_loop(
                defn, mesh, belief_in, _rows(obs_c, rows), ctrl_c[:, rows], train=train,
                eps_seq=eps_mb, u0_seq=uni_mb, enabled=enabled, axis_name=particle_axis_name)
        return defn.forward_loop(belief_in, _rows(obs_c, rows), ctrl_c[:, rows], train=train,
                                 enabled=enabled, eps_seq=eps_mb, uniforms_seq=uni_mb)

    leaves, spec = pytree.tree_flatten(belief)

    def chunk(mine, rows):
        out, est = run_chunk(pytree.tree_unflatten(mine, spec), rows)
        return pytree.tree_leaves(out), est

    with torch.set_grad_enabled(train):
        final, est = run_schedule(mesh, axis_name, micro, leaves, chunk, train=train)
    return (belief if train else pytree.tree_unflatten(final, spec)), est
