"""Data-parallel training and eval over a mesh, and the routing of a filter
loop over any grid of the data, pipe and particle axes (port of
``multimodalfilter_tpu/parallel/data_parallel.py``, whose GSPMD and
``shard_map`` variants are one thing here: an explicit all-reduce).

- ``mesh_forward_loop``: a filter loop over global inputs on a grid. The
  noise is the global draw, from a generator seeded the same on every rank,
  so W ranks compute what one device computes; each rank takes its rows
  (data axis) and its particle block (particle axis), runs the pipelined
  loop (pipe axis), the particle-sharded loop, or the def's own
  ``forward_loop`` (data axis alone: B1, B4, B5 or B3 as on one device),
  and the estimates and the final belief are gathered in mesh order.
- ``TrainShard``: what ``train/loops.py::train_e2e`` needs on a mesh: the
  rank's rows of each batch, its loop, and one flat all-reduce per
  optimizer step that sums the gradient shares over the mesh and averages
  over the data axis.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch

from ..filtering.pf import ParticleFilterDef
from ..types import ParticleBelief
from . import collectives
from .mesh import axis_names, axis_size, block, local_rows
from .particle_sharding import particle_sharded_loop
from .temporal_pipeline import pipelined_loop


class Layout(NamedTuple):
    """How a loop spreads over `mesh`: the axis its time chunks run on,
    the microbatches, and the axes its trajectories and particles split
    over (each None when the loop does not use it)."""

    mesh: object
    pipe_axis: Optional[str] = None
    micro: int = 1
    data_axis: Optional[str] = None
    particle_axis: Optional[str] = None


def auto_microbatches(n: int, cap: int = 8) -> int:
    """The largest divisor of `n` up to `cap`: GPipe fills at
    micro/(stages + micro - 1)."""
    for m in range(min(cap, n), 0, -1):
        if n % m == 0:
            return m
    return 1


def draw_loop_noise(defn, belief, t: int, n: int, *, train: bool, generator,
                    particle_axis: Optional[str] = None):
    """The PF's draws for a loop of `t` steps over `n` trajectories, in the
    order and shapes of ``ParticleFilterDef.forward_loop``: ``eps_seq`` (t,
    n*M, D), then in eval ``uniforms_seq`` (t, n, M), or with a particle
    axis the stratified offsets (t, n). (None, None) for the other defs,
    which draw nothing."""
    if not isinstance(defn, ParticleFilterDef):
        return None, None
    particles = belief.particles
    m, d = particles.shape[1], particles.shape[2]
    eps = torch.randn((t, n * m, d), generator=generator, dtype=particles.dtype,
                      device=particles.device)
    if train:
        return eps, None
    shape = (t, n) if particle_axis is not None else (t, n, m)
    return eps, torch.rand(shape, generator=generator, dtype=particles.dtype,
                           device=particles.device)


def type_map(tree, fn):
    """`fn` over the tensors of a belief (a tensor or nested tuples and
    named tuples of them)."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    parts = [type_map(v, fn) for v in tree]
    return type(tree)(*parts) if hasattr(tree, "_fields") else type(tree)(parts)


def mesh_forward_loop(defn, layout: Layout, belief, observations_seq, controls_seq, *,
                      train: bool, enabled: Optional[Tuple[bool, ...]] = None,
                      eps_seq=None, uniforms_seq=None, generator=None):
    """The filter loop on `layout`'s grid, over global inputs: `belief`
    (N trajectories, and M particles for a PF), observations (T, N, ...)
    and controls (T, N, C); the PF's noise as ``draw_loop_noise`` gives it,
    drawn from `generator` where not given. T must divide over the pipe
    axis. Returns (final belief, estimates (T, N, D)), gathered over the
    data and particle axes; in training the estimates are differentiable
    and the final belief is this rank's."""
    mesh = layout.mesh
    t, n = controls_seq.shape[:2]
    if eps_seq is None:
        eps_seq, drawn = draw_loop_noise(defn, belief, t, n, train=train, generator=generator,
                                         particle_axis=layout.particle_axis)
        uniforms_seq = drawn if uniforms_seq is None else uniforms_seq
    rows = block(n, mesh, layout.data_axis)
    belief = local_rows(belief, mesh, layout.data_axis)
    observations_seq = local_rows(observations_seq, mesh, layout.data_axis, axis=1)
    controls_seq = local_rows(controls_seq, mesh, layout.data_axis, axis=1)
    if eps_seq is not None:
        m, d = belief.particles.shape[1:]
        eps = eps_seq.reshape(t, n, m, d)[:, rows]
        if uniforms_seq is not None:
            uniforms_seq = uniforms_seq[:, rows]
        if layout.particle_axis is not None:
            cols = block(m, mesh, layout.particle_axis)
            eps = eps[:, :, cols]
            belief = ParticleBelief(belief.particles[:, cols], belief.log_weights[:, cols])
        eps_seq = eps.reshape(t, -1, d)

    if layout.pipe_axis is not None:
        belief, est = pipelined_loop(
            defn, mesh, belief, observations_seq, controls_seq, train=train,
            enabled=enabled, eps_seq=eps_seq, uniforms_seq=uniforms_seq,
            axis_name=layout.pipe_axis, num_microbatches=layout.micro,
            particle_axis_name=layout.particle_axis)
    elif layout.particle_axis is not None:
        belief, est = particle_sharded_loop(
            defn, mesh, belief, observations_seq, controls_seq, train=train,
            eps_seq=eps_seq, u0_seq=uniforms_seq, enabled=enabled,
            axis_name=layout.particle_axis)
    else:
        belief, est = defn.forward_loop(belief, observations_seq, controls_seq, train=train,
                                        enabled=enabled, eps_seq=eps_seq,
                                        uniforms_seq=uniforms_seq)
    est = collectives.all_gather(est, mesh, layout.data_axis, dim=1)
    if train:  # the loss reads the estimates alone
        return belief, est
    if layout.particle_axis is not None:
        belief = ParticleBelief(
            *(collectives.all_gather(v, mesh, layout.particle_axis, dim=1) for v in belief))
    if layout.data_axis is not None:
        belief = type_map(belief, lambda v: collectives.all_gather(v, mesh, layout.data_axis))
    return belief, est


@dataclasses.dataclass(frozen=True)
class TrainShard:
    """A rank's part of data-parallel or pipelined training on `mesh`:
    `rows` of each global batch of `batch_size`, and the loop `layout` (the
    pipe and particle axes; None for the def's own loop)."""

    mesh: object
    rows: slice
    batch_size: int
    data_size: int
    layout: Optional[Layout]

    def loop(self, defn, belief, observations_seq, controls_seq, *, enabled, eps_seq=None):
        if self.layout is None:
            return defn.forward_loop(belief, observations_seq, controls_seq, train=True,
                                     enabled=enabled, eps_seq=eps_seq)
        return mesh_forward_loop(defn, self.layout, belief, observations_seq, controls_seq,
                                 train=True, enabled=enabled, eps_seq=eps_seq)

    def broadcast_parameters(self, module: torch.nn.Module) -> None:
        """Rank 0's parameters on every rank, in one message."""
        collectives.broadcast_(list(module.parameters()), self.mesh, collectives.WHOLE_MESH, 0)

    def all_reduce_gradients(self, module: torch.nn.Module, loss: torch.Tensor) -> torch.Tensor:
        """One flat all-reduce over the mesh of every gradient and the loss:
        each gradient summed over the ranks (every rank holds its share of
        a replicated parameter's gradient) and averaged over the data axis
        (each data rank's loss is the mean over its own rows). Returns the
        loss of the global batch."""
        params = list(module.parameters())
        world = collectives.whole_mesh_size(self.mesh)
        flat = torch.cat([p.grad.reshape(-1) for p in params]
                         + [loss.detach().reshape(1) * (self.data_size / world)])
        collectives.all_reduce_sum_(flat, self.mesh, collectives.WHOLE_MESH)
        flat /= self.data_size
        for p, g in zip(params, collectives.unflatten(flat[:-1], params)):
            p.grad.copy_(g)
        return flat[-1]


def train_shard(defn, mesh, *, batch_size: int, seq_len: int, pipelined: bool,
                microbatches: Optional[int] = None) -> TrainShard:
    """The ``TrainShard`` of ``train_e2e(mesh=...)`` (`pipelined` False: a
    mesh with a "data" axis) or ``train_e2e(pipeline_mesh=...)`` (a "pipe"
    axis, with "data" and "particle" axes where present). Raises where the
    batch, the steps or the particles do not split."""
    names = axis_names(mesh)
    known = ("data", "pipe", "particle") if pipelined else ("data",)
    if set(names) - set(known):
        raise ValueError(f"a training mesh has the axes {known}, not {names}")
    data_axis = "data" if "data" in names else None
    if not pipelined and data_axis is None:
        raise ValueError(f"a data-parallel mesh needs a 'data' axis, not {names}")
    data_size = axis_size(mesh, data_axis)
    if batch_size % data_size:
        raise ValueError(f"batch_size {batch_size} does not divide over the {data_size}-way "
                         "data axis (--data-parallel)")
    layout = None
    if pipelined:
        if "pipe" not in names:
            raise ValueError(f"a pipeline mesh needs a 'pipe' axis, not {names}")
        stages = axis_size(mesh, "pipe")
        if (seq_len - 1) % stages:
            raise ValueError(f"subsequence steps {seq_len - 1} do not divide over "
                             f"{stages} stages")
        particle_axis = "particle" if "particle" in names else None
        if particle_axis is not None:
            if not isinstance(defn, ParticleFilterDef):
                raise ValueError("a 'particle' mesh axis splits a particle filter's "
                                 f"particles; {type(defn).__name__} has none")
            if defn.num_particles_train % axis_size(mesh, particle_axis):
                raise ValueError(f"num_particles_train {defn.num_particles_train} does not "
                                 f"divide over the {axis_size(mesh, particle_axis)}-way "
                                 "particle axis")
        per_shard = batch_size // data_size
        micro = auto_microbatches(per_shard) if microbatches is None else int(microbatches)
        if per_shard % micro:
            raise ValueError(f"per-shard batch {per_shard} does not divide into {micro} "
                             "microbatches")
        layout = Layout(mesh, "pipe", micro, None, particle_axis)
    return TrainShard(mesh, block(batch_size, mesh, data_axis), batch_size, data_size, layout)
