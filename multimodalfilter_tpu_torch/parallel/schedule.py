"""The GPipe schedule of the temporal pipeline over flat belief leaves
(the port's counterpart of ``_run_pipeline`` in the JAX package's
``parallel/temporal_pipeline.py``). ``temporal_pipeline.pipelined_loop``
runs it around a def's loop, and a pipelined serving bundle
(``experiments/export.py``) around its exported chunk program, so this
module imports no filter code.

Stage s of the axis runs its time chunk on each of `micro` microbatches in
order: it receives the microbatch's belief from stage s-1 (stage 0 slices
it from the initial belief), runs the chunk and sends the belief on to
stage s+1. The sends and receives pace the stages into the
``P + micro - 1`` steps of the schedule. The last stage broadcasts the
final belief; an all-gather assembles the stages' estimates in time order.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import torch

from . import collectives
from .mesh import axis_index, axis_size


def run_schedule(mesh, axis_name: str, micro: int, leaves: Sequence[torch.Tensor],
                 run_chunk: Callable, *, train: bool
                 ) -> Tuple[Optional[List[torch.Tensor]], torch.Tensor]:
    """`leaves`: the initial belief's tensors, batch on axis 0 (stage 0
    reads their values, the other stages their shapes); `run_chunk(leaves,
    rows)` runs this stage's chunk on the microbatch `rows` and returns
    (its final leaves, estimates (T/P, rows, D)). Returns (the final leaves,
    the same on every stage; None in training) and the estimates (T, N, D)
    of every stage, differentiable in training."""
    stages = axis_size(mesh, axis_name)
    stage = axis_index(mesh, axis_name)
    n = leaves[0].shape[0]
    if n % micro:
        raise ValueError(f"batch {n} does not divide into {micro} microbatches")
    nm = n // micro
    tokens, estimates, finals = [], [], []
    for mc in range(micro):
        rows = slice(mc * nm, (mc + 1) * nm)
        mine = [x[rows] for x in leaves]
        if stage > 0:
            like = torch.empty_like(collectives.flatten(mine).detach())
            mine = collectives.unflatten(collectives.recv_prev(like, mesh, axis_name, train),
                                         mine)
        out, est = run_chunk(mine, rows)
        estimates.append(est)
        if stage < stages - 1:
            tokens.append(collectives.send_next(collectives.flatten(out), mesh, axis_name,
                                                train))
        else:
            finals.append(out)
    est = torch.cat(estimates, dim=1)
    if train and tokens:
        # The tokens are zeros: adding them puts the sends' backwards, which
        # receive the belief cotangents, on the loss's graph.
        est = est + torch.stack(tokens).sum()
    est = collectives.all_gather(est, mesh, axis_name, dim=0)
    if train:
        return None, est
    final = [torch.cat(parts, dim=0) for parts in zip(*finals)] if finals else [
        torch.empty_like(x) for x in leaves]
    collectives.broadcast_(final, mesh, axis_name, stages - 1)
    return final, est
