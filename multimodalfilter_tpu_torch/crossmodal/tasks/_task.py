"""Task registry (port of ``crossmodal/tasks/_task.py``).

Each Task subclass gets its own ``Filter`` marker class; a model that lists
``DoorTask.Filter`` as a base registers itself in ``DoorTask.model_types``
under its class name, which is the set of ``--model-type`` choices.
"""

from __future__ import annotations

import abc
import argparse
from typing import Dict

from ...filtering.wrappers import StatefulFilter


class Task(abc.ABC):
    model_types: Dict[str, type] = {}
    Filter: type = None

    def __init__(self, *unused_args, **unused_kwargs):
        raise TypeError("Cannot instantiate task object")

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        cls.model_types = {}

        class Filter:
            def __init_subclass__(cls_inner, **inner_kwargs):
                super().__init_subclass__(**inner_kwargs)
                if not issubclass(cls_inner, StatefulFilter):
                    raise TypeError(f"{cls_inner.__name__} is not a StatefulFilter")
                cls.model_types[cls_inner.__name__] = cls_inner

        cls.Filter = Filter

    @classmethod
    @abc.abstractmethod
    def add_dataset_arguments(cls, parser: argparse.ArgumentParser) -> None:
        ...

    @classmethod
    @abc.abstractmethod
    def get_dataset_args(cls, args: argparse.Namespace) -> Dict:
        ...

    @classmethod
    @abc.abstractmethod
    def get_train_trajectories(cls, **dataset_args):
        ...

    @classmethod
    @abc.abstractmethod
    def get_eval_trajectories(cls, **dataset_args):
        ...
