"""Task registries and dataset loaders (port of ``crossmodal/tasks``)."""

from ._door import DoorTask
from ._push import PushTask
from ._task import Task

__all__ = ["DoorTask", "PushTask", "Task"]
