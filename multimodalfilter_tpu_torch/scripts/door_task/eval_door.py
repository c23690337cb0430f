"""Door-task eval CLI (port of ``scripts/door_task/eval_door.py``).

    python -m multimodalfilter_tpu_torch.scripts.door_task.eval_door \
        --experiment-name NAME [--checkpoint-label LABEL] [--save]

A checkpoint and its metadata determine the model: the metadata's
``model_type`` picks the class from ``DoorTask.model_types`` and its
``dataset_args`` the eval set; the checkpoint (``Buddy.load_checkpoint``,
the latest one without a label) fills its parameters. The eval is
``run_eval_stats`` (20 stochastic repeats), by default with the repeats
folded into the batch axis. Runs on ``cuda`` unless ``--device`` says
otherwise. The parallelism flags run the eval on their mesh under
``torchrun --nproc-per-node N`` (``parallel/cli.py``); rank 0 writes
``--save``'s metadata. Checkpoints and metadata are read from ``checkpoints/`` and
``metadata/`` under the working directory; datasets from the repo's
``.cache/`` (where ``h5py`` is missing, set MMF_TPU_SYNTHESIZE_DATA=1 to
synthesise the eval set in memory).
"""

from __future__ import annotations

import argparse
import os
from pathlib import Path
from typing import Dict, Optional

from ...crossmodal import door_models  # noqa: F401  (registers the door models)
from ...crossmodal import eval_helpers
from ...crossmodal.tasks import DoorTask
from ...data import set_cache_path
from ...experiments import Buddy
from ...parallel.cli import (
    add_parallelism_args,
    add_serving_arg,
    apply_serving_arg,
    meshes_from_args,
)
from ...utils.debug import profile_trace

Task = DoorTask
REPO_CACHE_DIR = str(Path(__file__).resolve().parents[3] / ".cache")


def _parser(description: Optional[str] = None) -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=description or __doc__.split("\n\n")[0])
    parser.add_argument("--experiment-name", type=str, required=True)
    parser.add_argument("--checkpoint-label", type=str, default=None)
    parser.add_argument("--save", action="store_true",
                        help="write the stats into the experiment's metadata "
                             "(eval_results_stats)")
    parser.add_argument("--measurement_init", action="store_true")
    parser.add_argument(
        "--batched-repeats", action=argparse.BooleanOptionalAction, default=True,
        help="fold the 20 stochastic eval repeats into the batch axis (one "
        "(T, N*R) rollout per chunk instead of R rollouts of N); "
        "statistically the sequential path, not its random stream. "
        "Equivalent to MMF_TPU_EVAL_BATCH_REPEATS=1",
    )
    parser.add_argument(
        "--profile-dir", type=str, default=None, metavar="DIR",
        help="write a torch.profiler trace of the eval rollouts into DIR "
        "(a Chrome trace, trace.json)",
    )
    parser.add_argument("--device", type=str, default="cuda",
                        help="the device the model runs on (default cuda)")
    add_serving_arg(parser)
    add_parallelism_args(parser)
    return parser


def _profiled(profile_dir: Optional[str], fn):
    with profile_trace(profile_dir, enabled=profile_dir is not None):
        return fn()


def main(argv=None, *, cache_dir: Optional[str] = None) -> Dict[str, float]:
    """Run the eval CLI on `argv`; returns the stats. `cache_dir` replaces
    the repo's ``.cache/`` as the dataset cache."""
    return run(Task, argv, cache_dir=cache_dir)


def run(task, argv=None, *, cache_dir: Optional[str] = None,
        description: Optional[str] = None) -> Dict[str, float]:
    """The eval CLI of `task` (the door and push CLIs share it)."""
    args = _parser(description).parse_args(argv)
    apply_serving_arg(args)
    # Before the model is built: on CUDA this makes the rank's card current.
    mesh, pipeline_mesh = meshes_from_args(args, device=args.device)
    os.environ["MMF_TPU_EVAL_BATCH_REPEATS"] = "1" if args.batched_repeats else "0"

    set_cache_path(cache_dir or REPO_CACHE_DIR)

    buddy = Buddy(args.experiment_name)
    model_type = buddy.metadata["model_type"]
    dataset_args = buddy.metadata["dataset_args"]

    filter_model = task.model_types[model_type](device=args.device)
    buddy.attach_model(filter_model)
    buddy.load_checkpoint(label=args.checkpoint_label)

    eval_helpers.configure(
        buddy=buddy, task=task, dataset_args=dataset_args,
        # With both flags the grid carries the data axis; eval takes it alone.
        mesh=None if pipeline_mesh is not None else mesh,
        pipeline_mesh=pipeline_mesh, pipeline_microbatches=args.pipeline_microbatches,
    )
    results = _profiled(args.profile_dir, lambda: eval_helpers.run_eval_stats(
        measurement_initialize=args.measurement_init))

    if args.save:
        buddy.add_metadata({"eval_results_stats": results})
    return results


if __name__ == "__main__":
    main()
