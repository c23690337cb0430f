"""Push-task eval CLI (port of ``scripts/push_task/eval_push.py``).

    python -m multimodalfilter_tpu_torch.scripts.push_task.eval_push \
        --experiment-name NAME [--checkpoint-label LABEL] [--save]

The door eval CLI (``scripts/door_task/eval_door.py``: its flags, the model
rebuilt from the metadata's ``model_type`` and ``dataset_args``, which carry
``kloss_dataset``, and ``run_eval_stats``) over ``PushTask`` and the push
metrics (x and y RMSE in cm). Runs on ``cuda`` unless ``--device`` says
otherwise.
"""

from __future__ import annotations

from typing import Dict, Optional

from ...crossmodal import push_models  # noqa: F401  (registers the push models)
from ...crossmodal.tasks import PushTask
from ..door_task import eval_door

Task = PushTask


def main(argv=None, *, cache_dir: Optional[str] = None) -> Dict[str, float]:
    """Run the eval CLI on `argv`; returns the stats. `cache_dir` replaces
    the repo's ``.cache/`` as the dataset cache."""
    return eval_door.run(Task, argv, cache_dir=cache_dir,
                         description=__doc__.split("\n\n")[0])


if __name__ == "__main__":
    main()
