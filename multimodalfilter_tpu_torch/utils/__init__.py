"""Utilities of the port (port of ``multimodalfilter_tpu/utils``):
``precision.py``, the serving knobs' def rewrites; ``debug.py``, the train
CLI's debug affordances, the profiler trace, its spans and the finiteness
guard; ``conversions.py``, ``pytree.py``, ``slice_wrapper.py`` and
``rng.py``."""

from .conversions import to_device, to_numpy
from .debug import (
    checkify_filter_step,
    get_git_commit_hash,
    pdb_safety_net,
    profile_trace,
    span,
)
from .precision import (
    with_compute_dtype,
    with_fold_tail,
    with_fused_step,
    with_hoist_ctrl,
    with_hoist_rng,
    with_scan_unroll,
    with_stacked_encoders,
)
from .pytree import get_by_path, path_matches_prefix, set_by_path, torch_path_segments
from .rng import configure_prng_from_env, prng_impl_from_env
from .slice_wrapper import SliceWrapper

__all__ = [
    "SliceWrapper",
    "checkify_filter_step",
    "configure_prng_from_env",
    "get_by_path",
    "get_git_commit_hash",
    "path_matches_prefix",
    "pdb_safety_net",
    "prng_impl_from_env",
    "profile_trace",
    "set_by_path",
    "span",
    "to_device",
    "to_numpy",
    "torch_path_segments",
    "with_compute_dtype",
    "with_fold_tail",
    "with_fused_step",
    "with_hoist_ctrl",
    "with_hoist_rng",
    "with_scan_unroll",
    "with_stacked_encoders",
]
