"""Def-tree rewrites for the serving knobs (port of
``multimodalfilter_tpu/utils/precision.py``).

Each setter rebuilds a def tree with one field set on every def that has it;
the networks (``nn.Module``s) are shared, not copied. In the JAX package the
compute dtype and the fold are fields of the flax nets; here they are fields
of the defs that hold an observation net (``MeasurementDef``,
``VirtualSensorDef``, ``PFWeightDef``, ``KFWeightDef``; the LSTM's def takes
the fold only), passed to the net on each call, so a rebuilt def computes
differently from the def it was built from while both share one set of
parameters.
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


def with_compute_dtype(obj, dtype):
    """Set the ``dtype`` field throughout a def tree: every observation
    encoder computes in `dtype` (``torch.bfloat16`` for serving; None for
    fp32). Parameters stay fp32 and the features return in fp32 before the
    filter math."""
    return _with_field(obj, "dtype", dtype)


def with_fold_tail(obj, fold: bool = True):
    """Set the ``fold_tail`` field throughout a def tree: each image
    encoder applies its linear conv3 -> [pool] -> dense tail as one product
    (the same linear map, summed in another order; ``models/encoders.py``).
    Parameters are unchanged, so checkpoints serve either way."""
    return _with_field(obj, "fold_tail", fold)


def with_scan_unroll(obj, unroll: int):
    """Accepted for the JAX package's API, and changes nothing: there it
    sets ``scan_unroll``, the unroll factor of ``lax.scan``; the port's
    ``forward_loop`` is a Python loop and no def has the field."""
    del unroll
    return obj


def with_hoist_rng(obj, hoist: bool = True):
    """Accepted for the JAX package's API, and changes nothing: there it
    sets ``hoist_rng`` (draw a loop's noise and uniforms before the scan);
    the port's ``forward_loop`` always draws them before its loop, and no
    def has the field."""
    del hoist
    return obj


def with_hoist_ctrl(obj, hoist: bool = True):
    """Set the ``hoist_ctrl`` field throughout a def tree: an EKF's
    ``forward_loop`` encodes all T*N control rows in one batch before its
    loop (the same row math). Default on. The particle filters always hoist
    and have no such field."""
    return _with_field(obj, "hoist_ctrl", hoist)


def with_fused_step(obj, fused: bool = True):
    """Set the ``fused_step`` field throughout a def tree: the eval
    forward_loop runs as one kernel, B3 (``ops/fused_step.py``), when the
    config qualifies, and the per-step path otherwise. Serving knob
    (``MMF_TPU_FUSED_STEP=1``): the same recursion, sums in another order,
    so tie-level resampling draws can differ from the per-step path."""
    return _with_field(obj, "fused_step", fused)


def with_stacked_encoders(obj, stack: bool = True):
    """Set the ``stack_image_encoders`` field on every fusion def in the
    tree: the image encoders that read the same frame (a measurement model
    or virtual sensor and the gate) run as one stacked pass
    (``models/stacked.py``), each with its own parameters and math."""
    return _with_field(obj, "stack_image_encoders", stack)
