"""Experiment management (port of ``multimodalfilter_tpu/experiments``).

``Buddy`` and ``MetricLogger`` are imported when first named, so that
loading a serving bundle (``experiments.export``) pulls in no training or
model code."""

__all__ = ["Buddy", "MetricLogger"]


def __getattr__(name):
    if name == "Buddy":
        from .buddy import Buddy

        return Buddy
    if name == "MetricLogger":
        from .logging import MetricLogger

        return MetricLogger
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
