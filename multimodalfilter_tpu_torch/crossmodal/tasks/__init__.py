"""Task registries and dataset loaders (port of ``crossmodal/tasks``; the
push task comes with ROADMAP A11)."""

from ._door import DoorTask
from ._task import Task

__all__ = ["DoorTask", "Task"]
