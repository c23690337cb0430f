"""CLI flags of the parallelism layers and the serving stack (counterpart of
``multimodalfilter_tpu/parallel/cli.py``), shared by the door and push
train and eval CLIs:

    torchrun --nproc-per-node 4 -m ...train_door ... --data-parallel 4
    torchrun --nproc-per-node 4 -m ...eval_door  ... --pipeline-stages 4
    torchrun --nproc-per-node 8 -m ...eval_door  ... --data-parallel 2 \\
        --pipeline-stages 2 --particle-shards 2

The flags are the JAX package's and build the same meshes: the data mesh,
and the (data, pipe, particle) grid with the axes whose flags are set (pipe
always: a particle-only request rides a 1-stage pipe with one microbatch).
A mesh needs a world of as many ranks, one per device: launch with
``torchrun --nproc-per-node <product>``; a product above the world's size
exits, naming it, before anything is written. ``--serving`` sets
``MMF_TPU_SERVING=1``, as in the JAX package.
"""

from __future__ import annotations

import argparse
import math
import os
from typing import List, Optional, Tuple

_PARALLELISM_FLAGS = ("data_parallel", "pipeline_stages", "pipeline_microbatches",
                      "particle_shards")


def add_parallelism_args(parser: argparse.ArgumentParser) -> None:
    group = parser.add_argument_group(
        "parallelism (one process per device: torchrun --nproc-per-node N)")
    group.add_argument("--data-parallel", type=int, default=None, metavar="N",
                       help="shard the batch axis over N devices")
    group.add_argument("--pipeline-stages", type=int, default=None, metavar="N",
                       help="shard the time axis over N pipeline stages (GPipe, the belief "
                            "relayed stage to stage); with --data-parallel D, rollouts run "
                            "on the (D data x N pipe) grid of D*N devices")
    group.add_argument("--pipeline-microbatches", type=int, default=None, metavar="M",
                       help="microbatch count for --pipeline-stages (default: the largest "
                            "divisor of the per-data-shard batch up to 8)")
    group.add_argument("--particle-shards", type=int, default=None, metavar="Q",
                       help="shard the PF particle axis over Q devices inside each (data, "
                            "pipe) cell (particle filters only; M must divide by Q)")


def add_serving_arg(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--serving", action="store_true",
                        help="the serving stack (bf16 encoder compute and the folded "
                             "encoder tail), as MMF_TPU_SERVING=1; the per-knob "
                             "MMF_TPU_{BF16,FOLD_ENC} envs still override each part")


def apply_serving_arg(args) -> None:
    """Set ``MMF_TPU_SERVING=1`` from ``--serving``. Runs before any model
    is built: ``StatefulFilter`` reads the serving knobs when it is built
    (``filtering/wrappers.py::apply_serving_knobs``)."""
    if getattr(args, "serving", False):
        os.environ["MMF_TPU_SERVING"] = "1"


def mesh_layouts(args) -> Tuple[Optional[int], Optional[Tuple[List[str], List[int]]]]:
    """(the data mesh's size, the grid's (axes, shape)) that the flags ask
    for, either None; the JAX CLI's :110-147. A flag below 1 exits. A
    1-stage pipe with no microbatch flag takes one microbatch (splitting
    the batch would only shrink its products)."""
    for flag in _PARALLELISM_FLAGS:
        value = getattr(args, flag, None)
        if value is not None and value < 1:
            raise SystemExit(f"--{flag.replace('_', '-')} must be >= 1 (got {value})")
    data = getattr(args, "data_parallel", None)
    stages = getattr(args, "pipeline_stages", None)
    particle = getattr(args, "particle_shards", None)
    grid = None
    if stages is not None or particle is not None:
        axes, shape = [], []
        if data is not None:
            axes.append("data")
            shape.append(data)
        axes.append("pipe")
        shape.append(1 if stages is None else stages)
        if particle is not None:
            axes.append("particle")
            shape.append(particle)
        grid = (axes, shape)
        if stages in (None, 1) and getattr(args, "pipeline_microbatches", None) is None:
            args.pipeline_microbatches = 1
    return data, grid


def meshes_from_args(args, device=None):
    """(mesh, pipeline_mesh) from parsed CLI args, either possibly None, as
    the JAX CLI returns them: with both flags `pipeline_mesh` is the
    (data, pipe) grid and `mesh` the data mesh that trains BPTT; eval takes
    the grid alone. Joins torchrun's world first (``--device`` picks the
    backend). A mesh larger than the world exits, naming torchrun."""
    from .mesh import create_mesh, initialize_distributed, world_size

    data, grid = mesh_layouts(args)
    if data is None and grid is None:
        return None, None
    need = max(data or 1, math.prod(grid[1]) if grid else 1)
    initialize_distributed(device)
    if need > world_size():
        raise SystemExit(
            f"the parallelism flags ask for {need} devices and this world has "
            f"{world_size()} rank(s): launch with torchrun --nproc-per-node {need}")
    mesh = pipeline_mesh = None
    if grid is not None:
        pipeline_mesh = create_mesh(axis_names=tuple(grid[0]), shape=tuple(grid[1]),
                                    device=device)
    if data is not None:
        mesh = create_mesh(data, device=device) if grid is None else pipeline_mesh[("data",)]
    return mesh, pipeline_mesh
