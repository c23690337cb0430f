"""Utilities of the port (``utils/precision.py``: the serving knobs' def
rewrites)."""

from .precision import with_fused_step

__all__ = ["with_fused_step"]
