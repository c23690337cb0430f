"""Dynamics-only rollout evaluation (port of
``scripts/door_task/eval_dynamics.py``).

    python -m multimodalfilter_tpu_torch.scripts.door_task.eval_dynamics \
        --experiment-name NAME [--checkpoint-label LABEL] [--device cpu]

Isolates the dynamics model of a checkpointed door filter:
``run_eval(eval_dynamics=True)``, the noise-free ``dynamics_model``
rollout from the ground-truth first state (reference eval_dynamics.py:37,
eval_helpers.py:134-137). Checkpoints, metadata and datasets are found as
``eval_door`` finds them; runs on ``cuda`` unless ``--device`` says
otherwise.
"""

from __future__ import annotations

import argparse
from typing import Dict, Optional

from ...crossmodal import door_models  # noqa: F401  (registers the door models)
from ...crossmodal import eval_helpers
from ...crossmodal.tasks import DoorTask
from ...data import set_cache_path
from ...experiments import Buddy
from .eval_door import REPO_CACHE_DIR

Task = DoorTask


def main(argv=None, *, cache_dir: Optional[str] = None) -> Dict[str, float]:
    """Run the dynamics eval on `argv`; returns its metrics. `cache_dir`
    replaces the repo's ``.cache/`` as the dataset cache."""
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--experiment-name", type=str, required=True)
    parser.add_argument("--checkpoint-label", type=str, default=None)
    parser.add_argument("--device", type=str, default="cuda",
                        help="the device the model runs on (default cuda)")
    args = parser.parse_args(argv)

    set_cache_path(cache_dir or REPO_CACHE_DIR)

    buddy = Buddy(args.experiment_name)
    model_type = buddy.metadata["model_type"]
    dataset_args = buddy.metadata["dataset_args"]

    filter_model = Task.model_types[model_type](device=args.device)
    buddy.attach_model(filter_model)
    buddy.load_checkpoint(label=args.checkpoint_label)

    eval_helpers.configure(buddy=buddy, task=Task, dataset_args=dataset_args)
    return eval_helpers.run_eval(eval_dynamics=True)


if __name__ == "__main__":
    main()
