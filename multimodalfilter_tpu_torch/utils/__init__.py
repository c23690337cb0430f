"""Utilities of the port (``utils/precision.py``: the serving knobs' def
rewrites; ``utils/debug.py``: the train CLI's debug affordances)."""

from .debug import get_git_commit_hash, pdb_safety_net
from .precision import with_fused_step

__all__ = ["get_git_commit_hash", "pdb_safety_net", "with_fused_step"]
