"""Door-task eval CLI (port of ``scripts/door_task/eval_door.py``).

    python -m multimodalfilter_tpu_torch.scripts.door_task.eval_door \
        --experiment-name NAME [--checkpoint-label LABEL] [--save]

A checkpoint and its metadata determine the model: the metadata's
``model_type`` picks the class from ``DoorTask.model_types`` and its
``dataset_args`` the eval set; the checkpoint (``Buddy.load_checkpoint``,
the latest one without a label) fills its parameters. The eval is
``run_eval_stats`` (20 stochastic repeats), by default with the repeats
folded into the batch axis. Runs on ``cuda`` unless ``--device`` says
otherwise. Checkpoints and metadata are read from ``checkpoints/`` and
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

Task = DoorTask
REPO_CACHE_DIR = str(Path(__file__).resolve().parents[3] / ".cache")
_PARALLELISM_FLAGS = ("data_parallel", "pipeline_stages", "pipeline_microbatches",
                      "particle_shards")


def _parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
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
    parser.add_argument("--serving", action="store_true",
                        help="the serving stack, as MMF_TPU_SERVING=1 (not ported "
                             "yet: raises, ROADMAP A8)")
    group = parser.add_argument_group("parallelism (not ported yet: ROADMAP A13)")
    group.add_argument("--data-parallel", type=int, default=None, metavar="N")
    group.add_argument("--pipeline-stages", type=int, default=None, metavar="N")
    group.add_argument("--pipeline-microbatches", type=int, default=None, metavar="M")
    group.add_argument("--particle-shards", type=int, default=None, metavar="Q")
    return parser


def _profiled(profile_dir: Optional[str], fn):
    if profile_dir is None:
        return fn()
    import torch

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        out = fn()
    os.makedirs(profile_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(profile_dir, "trace.json"))
    return out


def main(argv=None, *, cache_dir: Optional[str] = None) -> Dict[str, float]:
    """Run the eval CLI on `argv`; returns the stats. `cache_dir` replaces
    the repo's ``.cache/`` as the dataset cache."""
    args = _parser().parse_args(argv)
    used = [f"--{f.replace('_', '-')}" for f in _PARALLELISM_FLAGS
            if getattr(args, f) is not None]
    if used:
        raise NotImplementedError(
            f"{', '.join(used)}: multi-device eval is not ported yet (ROADMAP A13)"
        )
    if args.serving:  # read when the model is built, which raises (A8)
        os.environ["MMF_TPU_SERVING"] = "1"
    os.environ["MMF_TPU_EVAL_BATCH_REPEATS"] = "1" if args.batched_repeats else "0"

    set_cache_path(cache_dir or REPO_CACHE_DIR)

    buddy = Buddy(args.experiment_name)
    model_type = buddy.metadata["model_type"]
    dataset_args = buddy.metadata["dataset_args"]

    filter_model = Task.model_types[model_type](device=args.device)
    buddy.attach_model(filter_model)
    buddy.load_checkpoint(label=args.checkpoint_label)

    eval_helpers.configure(buddy=buddy, task=Task, dataset_args=dataset_args)
    results = _profiled(args.profile_dir, lambda: eval_helpers.run_eval_stats(
        measurement_initialize=args.measurement_init))

    if args.save:
        buddy.add_metadata({"eval_results_stats": results})
    return results


if __name__ == "__main__":
    main()
