"""Def-tree rewrites for the serving knobs (port of
``multimodalfilter_tpu/utils/precision.py``).

Only ``with_fused_step`` so far. The bf16 encoders (``with_compute_dtype``)
and the folded encoder tail (``with_fold_tail``) wait for their features
(ROADMAP A8); the JAX package's ``scan_unroll`` and ``hoist_*`` knobs have
nothing to set in the port, whose ``forward_loop`` is a Python loop with the
hoists always on.
"""

from __future__ import annotations

import dataclasses


def _with_field(obj, field_name: str, field_value):
    """Recursively rebuild a (frozen-dataclass) def tree, setting
    ``field_name`` on every dataclass that has that field. Networks
    (``nn.Module``s) are shared, not copied."""
    if isinstance(obj, tuple):
        return tuple(_with_field(x, field_name, field_value) for x in obj)
    if not dataclasses.is_dataclass(obj) or isinstance(obj, type):
        return obj
    changes = {}
    for field in dataclasses.fields(obj):
        if field.name == field_name:
            changes[field_name] = field_value
            continue
        value = getattr(obj, field.name)
        new_value = _with_field(value, field_name, field_value)
        if new_value is not value:
            changes[field.name] = new_value
    if not changes:
        return obj
    return dataclasses.replace(obj, **changes)


def with_fused_step(obj, fused: bool = True):
    """Set the ``fused_step`` field throughout a def tree: the eval
    forward_loop runs as one kernel, B3 (``ops/fused_step.py``), when the
    config qualifies, and the per-step path otherwise. Serving knob
    (``MMF_TPU_FUSED_STEP=1``): the same recursion, sums in another order,
    so tie-level resampling draws can differ from the per-step path."""
    return _with_field(obj, "fused_step", fused)
