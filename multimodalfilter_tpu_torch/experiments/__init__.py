"""Experiment management (port of ``multimodalfilter_tpu/experiments``)."""

from .buddy import Buddy
from .logging import MetricLogger

__all__ = ["Buddy", "MetricLogger"]
