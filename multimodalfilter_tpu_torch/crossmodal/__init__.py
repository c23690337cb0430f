"""Task model zoo and the eval and training helpers of the port
(counterpart of the repo's ``crossmodal/``)."""

from . import door_models, eval_helpers, tasks, train_helpers

__all__ = ["door_models", "eval_helpers", "tasks", "train_helpers"]
