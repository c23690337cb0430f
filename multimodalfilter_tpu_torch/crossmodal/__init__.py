"""Task model zoos and the eval and training helpers of the port
(counterpart of the repo's ``crossmodal/``)."""

from . import base_models, door_models, eval_helpers, push_models, tasks, train_helpers

__all__ = ["base_models", "door_models", "eval_helpers", "push_models", "tasks",
           "train_helpers"]
