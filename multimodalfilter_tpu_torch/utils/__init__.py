"""Utilities of the port (``utils/precision.py``: the serving knobs' def
rewrites; ``utils/debug.py``: the train CLI's debug affordances)."""

from .debug import get_git_commit_hash, pdb_safety_net
from .precision import (
    with_compute_dtype,
    with_fold_tail,
    with_fused_step,
    with_hoist_ctrl,
    with_hoist_rng,
    with_scan_unroll,
    with_stacked_encoders,
)

__all__ = [
    "get_git_commit_hash",
    "pdb_safety_net",
    "with_compute_dtype",
    "with_fold_tail",
    "with_fused_step",
    "with_hoist_ctrl",
    "with_hoist_rng",
    "with_scan_unroll",
    "with_stacked_encoders",
]
