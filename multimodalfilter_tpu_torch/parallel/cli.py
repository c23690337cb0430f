"""CLI flags of the parallelism layers and the serving stack (counterpart of
``multimodalfilter_tpu/parallel/cli.py``), shared by the door train and eval
CLIs.

The flags are the JAX package's, so a command line written for it parses
here. ``--serving`` sets ``MMF_TPU_SERVING=1``, as in the JAX package. The
port has no multi-device path yet (ROADMAP A13): a parallelism flag raises
``NotImplementedError`` naming the item rather than run on one device
without saying so.
"""

from __future__ import annotations

import argparse
import os

_PARALLELISM_FLAGS = ("data_parallel", "pipeline_stages", "pipeline_microbatches",
                      "particle_shards")


def add_parallelism_args(parser: argparse.ArgumentParser) -> None:
    group = parser.add_argument_group("parallelism (not ported yet: ROADMAP A13)")
    group.add_argument("--data-parallel", type=int, default=None, metavar="N",
                       help="shard the batch axis over N devices")
    group.add_argument("--pipeline-stages", type=int, default=None, metavar="N",
                       help="shard the time axis over N pipeline stages")
    group.add_argument("--pipeline-microbatches", type=int, default=None, metavar="M",
                       help="microbatch count for --pipeline-stages")
    group.add_argument("--particle-shards", type=int, default=None, metavar="Q",
                       help="shard the PF particle axis over Q devices")


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


def meshes_from_args(args) -> None:
    """Refuse the parallelism flags: the port runs on one device, so there
    is no mesh to build. A flag below 1 exits as in the JAX package; any
    other flag raises."""
    used = []
    for flag in _PARALLELISM_FLAGS:
        value = getattr(args, flag, None)
        if value is None:
            continue
        if value < 1:
            raise SystemExit(f"--{flag.replace('_', '-')} must be >= 1 (got {value})")
        used.append(f"--{flag.replace('_', '-')}")
    if used:
        raise NotImplementedError(
            f"{', '.join(used)}: multi-device training and eval are not ported yet "
            "(ROADMAP A13)"
        )
