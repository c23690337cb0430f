"""The program's spans in a traced segment: the ``mmf.*`` ranges that
``multimodalfilter_tpu_torch`` opens at its layer boundaries while a
profiler runs (``utils/debug.py::span``). They are ``record_function``
ranges, so ``Trace`` reads them as host operators on the clock of the
device's events. The names are written out here, since the benchmark does
not import the program; a test holds them to the program's constants.

Every function reads the public fields of ``portbench.trace.Trace`` and
works on the thread that ran the traced segment (``main_tid``). Times are
in microseconds, like the trace's.
"""

from __future__ import annotations

import bisect
from typing import Iterable, List, Tuple

from .trace import _merge as merge

PREFIX = "mmf."
FACADE_INITIALIZE = "mmf.facade.initialize_beliefs"
FACADE_FORWARD_LOOP = "mmf.facade.forward_loop"
PF_ENCODE = "mmf.pf.encode"
PF_STEP = "mmf.pf.step"
PF_DYNAMICS = "mmf.pf.dynamics"
PF_MEASUREMENT = "mmf.pf.measurement"
PF_TAIL = "mmf.pf.tail"
FUSED_PACK = "mmf.fused.pack"
FUSED_LAUNCH = "mmf.fused.launch"
NAMES = (FACADE_INITIALIZE, FACADE_FORWARD_LOOP, PF_ENCODE, PF_STEP, PF_DYNAMICS,
         PF_MEASUREMENT, PF_TAIL, FUSED_PACK, FUSED_LAUNCH)

FACADE = frozenset({FACADE_INITIALIZE, FACADE_FORWARD_LOOP})
# The step layer's outermost spans: a per-step loop's steps, or the fused
# route's packing and its one launch.
STEP_LAYER = frozenset({PF_STEP, FUSED_PACK, FUSED_LAUNCH})

Interval = Tuple[float, float]


def length(intervals: Iterable[Interval]) -> float:
    return sum(b - a for a, b in intervals)


def intersect(xs: List[Interval], ys: List[Interval]) -> List[Interval]:
    """The intersection of two sorted disjoint interval lists."""
    out, i, j = [], 0, 0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        if a < b:
            out.append((a, b))
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return out


def intervals(trace, names) -> List[Interval]:
    """The merged intervals of the spans named in `names` on the main
    thread (empty when the trace holds none)."""
    return merge((start, start + dur) for name, start, dur, tid in trace.host_ops
                 if tid == trace.main_tid and name in names)


def self_time(trace, names) -> float:
    """The spans' self time: their merged intervals less the parts that
    the ``mmf.*`` spans nested in them, and not named in `names`, cover."""
    own = intervals(trace, names)
    starts = [a for a, _ in own]

    def inside(a: float, b: float) -> bool:
        i = bisect.bisect_right(starts, a) - 1
        return i >= 0 and own[i][1] >= b

    children = merge((start, start + dur) for name, start, dur, tid in trace.host_ops
                     if tid == trace.main_tid and name.startswith(PREFIX)
                     and name not in names and inside(start, start + dur))
    return length(own) - length(intersect(own, children))


def idle_within(trace, names) -> float:
    """Device idle while the main thread is inside a span named in
    `names`: the traced window less the union of the device's operations,
    intersected with the spans' merged intervals."""
    edges = [trace.window_start] + [x for iv in trace.busy_intervals() for x in iv] + [
        trace.window_end]
    idle = [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]
    return length(intersect(idle, intervals(trace, names)))
