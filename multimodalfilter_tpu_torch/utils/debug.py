"""Debug affordances (port of ``multimodalfilter_tpu/utils/debug.py``):
``pdb_safety_net`` and ``get_git_commit_hash`` for the train CLI (copies);
``profile_trace``, a ``torch.profiler`` trace around a hot region, and
``span``, a named range inside that trace at a layer boundary of the
program; and ``checkify_filter_step``, a finiteness guard on a filter
step's outputs."""

from __future__ import annotations

import contextlib
import os
import pdb
import subprocess
import sys
import traceback
from typing import Optional

import torch


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


@contextlib.contextmanager
def profile_trace(log_dir: str, enabled: bool = True):
    """A ``torch.profiler`` trace of the region, host and (where CUDA is
    available) device activity, written as a Chrome trace,
    ``<log_dir>/trace.json`` (chrome://tracing or Perfetto). Yields the
    profiler, or None when not ``enabled``."""
    if not enabled:
        yield None
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


# The program's spans, one at each layer boundary of an eval loop (PERF.md
# section 3 names the metric that reads each). The facade: one
# forward_loop span is one request.
SPAN_FACADE_INITIALIZE = "mmf.facade.initialize_beliefs"
SPAN_FACADE_FORWARD_LOOP = "mmf.facade.forward_loop"
# The hoisted encoder pass over every frame of the loop.
SPAN_PF_ENCODE = "mmf.pf.encode"
# One particle-filter step, and its three stages inside it.
SPAN_PF_STEP = "mmf.pf.step"
SPAN_PF_DYNAMICS = "mmf.pf.dynamics"
SPAN_PF_MEASUREMENT = "mmf.pf.measurement"
SPAN_PF_TAIL = "mmf.pf.tail"
# The fused route: B3's operands packed, then the packed loop run.
SPAN_FUSED_PACK = "mmf.fused.pack"
SPAN_FUSED_LAUNCH = "mmf.fused.launch"
SPANS = (SPAN_FACADE_INITIALIZE, SPAN_FACADE_FORWARD_LOOP, SPAN_PF_ENCODE, SPAN_PF_STEP,
         SPAN_PF_DYNAMICS, SPAN_PF_MEASUREMENT, SPAN_PF_TAIL, SPAN_FUSED_PACK,
         SPAN_FUSED_LAUNCH)

_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A ``torch.profiler.record_function`` range named `name` while a
    profiler runs (``profile_trace``, or any ``torch.profiler.profile``), on
    the clock of the trace's device events; otherwise a context that does
    nothing, at the cost of one check (entering ``record_function`` with no
    profiler costs ~100 times more). Under a tracer (export, compile,
    ``make_fx``) it does nothing either, so no profiler op enters a traced
    program."""
    if not torch._C._autograd._profiler_enabled():
        return _NO_SPAN
    from ..ops.custom_ops import tracing  # ops imports this module

    if tracing():
        return _NO_SPAN
    return torch.profiler.record_function(name)


class FloatCheckError:
    """The error half of ``checkify_filter_step``'s result: ``throw()``
    raises ``FloatingPointError`` if a floating output was not finite."""

    def __init__(self, message: Optional[str]):
        self.message = message

    def get(self) -> Optional[str]:
        return self.message

    def throw(self) -> None:
        if self.message is not None:
            raise FloatingPointError(self.message)


def checkify_filter_step(step_fn):
    """Wrap a filter step so that it returns (error, result), where
    ``error.throw()`` raises if a floating tensor of the result holds a NaN
    or an infinity: the counterpart of the JAX package's checkify guard
    (and of the reference's inline asserts, e.g.
    crossmodal/base_models/crossmodal_kf.py:112-143).

    Unlike ``jax.experimental.checkify``, which instruments every operation
    of the step and so also flags a non-finite intermediate that a later
    operation hides (a NaN under a ``where``, say), this checks the step's
    outputs only, after it ran: one reduction on the device per output,
    read back once."""

    def checked(*args, **kwargs):
        result = step_fn(*args, **kwargs)
        leaves = []

        def walk(x, path):
            if isinstance(x, torch.Tensor):
                if x.is_floating_point():
                    leaves.append((path, x))
            elif isinstance(x, dict):
                for k, v in x.items():
                    walk(v, f"{path}[{k!r}]")
            elif isinstance(x, (list, tuple)):
                for i, v in enumerate(x):
                    walk(v, f"{path}[{i}]")

        walk(result, "result")
        if not leaves:
            return FloatCheckError(None), result
        finite = torch.stack([torch.isfinite(x).all() for _, x in leaves]).tolist()
        bad = [path for (path, _), ok in zip(leaves, finite) if not ok]
        message = f"non-finite values in {', '.join(bad)}" if bad else None
        return FloatCheckError(message), result

    return checked
