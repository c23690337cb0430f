"""Resampling primitives and the hand-written kernels with their plain
versions (port of ``multimodalfilter_tpu/ops``)."""

from .resampling import multinomial_resample, soft_resample, systematic_resample

__all__ = ["multinomial_resample", "soft_resample", "systematic_resample"]
