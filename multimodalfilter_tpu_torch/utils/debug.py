"""Debug affordances of the train CLI (copy of ``pdb_safety_net`` and
``get_git_commit_hash`` from ``multimodalfilter_tpu/utils/debug.py``; the
JAX package's checkify and profiler helpers have no counterpart here)."""

from __future__ import annotations

import os
import pdb
import subprocess
import sys
import traceback
from typing import Optional


def pdb_safety_net() -> None:
    """Drop into pdb on any uncaught exception (interactive runs only: a
    run without a terminal, as on a batch machine, prints the traceback and
    exits)."""

    def excepthook(exc_type, exc_value, exc_traceback):
        traceback.print_exception(exc_type, exc_value, exc_traceback)
        if sys.stdin.isatty():
            pdb.post_mortem(exc_traceback)

    sys.excepthook = excepthook


def get_git_commit_hash(path: Optional[str] = None) -> str:
    try:
        cwd = os.path.dirname(path) if path else None
        return (
            subprocess.check_output(
                ["git", "rev-parse", "HEAD"], cwd=cwd, stderr=subprocess.DEVNULL
            )
            .decode()
            .strip()
        )
    except (OSError, subprocess.SubprocessError):  # no git, or not a checkout
        return "(unknown)"
