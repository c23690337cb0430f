"""The traced segment of a ``--trace 1`` run: ``torch.profiler`` over a
fixed amount of the cell's work, read back from its Chrome trace.

``Trace`` holds the device operations (kernels, copies, sets), the host's
operator ranges and the launch records that tie a kernel to the host call
that launched it. The traced window is the benchmark's own
``portbench.traced`` range, which ends after a synchronise, so every
device operation of the segment lies inside it.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
from collections import defaultdict
from typing import Callable, Iterable, List, Optional, Tuple

import torch

WINDOW_NAME = "portbench.traced"
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATEGORIES = ("cuda_runtime", "cuda_driver")
HOST_CATEGORIES = ("cpu_op", "user_annotation")
NAME_CHARS = 120  # a kernel's name in the breakdown, cut (C++ signatures run long)


def _merge(intervals: Iterable[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged: List[List[float]] = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return [(a, b) for a, b in merged]


class Trace:
    """Events of one traced segment; times in microseconds."""

    def __init__(self, events: list):
        self.device_ops = []   # (name, start, dur, category, correlation)
        self.host_ops = []     # (name, start, dur, tid)
        self.launches = {}     # correlation -> (start, tid)
        window = None
        for ev in events:
            if ev.get("ph") != "X":
                continue
            cat, name = ev.get("cat", ""), ev.get("name", "")
            start, dur = float(ev.get("ts", 0.0)), float(ev.get("dur", 0.0))
            corr = (ev.get("args") or {}).get("correlation")
            if cat in DEVICE_CATEGORIES:
                self.device_ops.append((name, start, dur, cat, corr))
            elif cat in LAUNCH_CATEGORIES and corr is not None:
                self.launches[corr] = (start, ev.get("tid"))
            elif cat in HOST_CATEGORIES:
                self.host_ops.append((name, start, dur, ev.get("tid")))
                if name == WINDOW_NAME:
                    window = (start, start + dur, ev.get("tid"))
        if window is None:
            raise RuntimeError(f"the trace holds no {WINDOW_NAME} range")
        self.window_start, self.window_end, self.main_tid = window

    @property
    def window_s(self) -> float:
        return (self.window_end - self.window_start) / 1e6

    @property
    def kernels(self):
        return [op for op in self.device_ops if op[3] == "kernel"]

    def busy_intervals(self) -> List[Tuple[float, float]]:
        """The union of the device operations' intervals, clipped to the
        window."""
        return _merge((max(s, self.window_start), min(s + d, self.window_end))
                      for _, s, d, _, _ in self.device_ops
                      if s + d > self.window_start and s < self.window_end)

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e6

    def kernel_seconds(self, substring: str) -> Tuple[int, float]:
        """(launches, device seconds) of the kernels whose name holds
        `substring`."""
        hits = [d for name, _, d, _, _ in self.kernels if substring in name]
        return len(hits), sum(hits) / 1e6

    def kernels_launched_under(self, host_op_names) -> Tuple[int, float]:
        """(kernels, device seconds) of the kernels launched while a host
        operator named in `host_op_names` ran on the launching thread."""
        ranges = defaultdict(list)
        for name, start, dur, tid in self.host_ops:
            if name in host_op_names:
                ranges[tid].append((start, start + dur))
        merged = {tid: _merge(r) for tid, r in ranges.items()}
        starts = {tid: [a for a, _ in r] for tid, r in merged.items()}
        count, seconds = 0, 0.0
        for _, _, dur, cat, corr in self.device_ops:
            launch = self.launches.get(corr) if cat == "kernel" else None
            if launch is None or launch[1] not in merged:
                continue
            t, tid = launch
            i = bisect.bisect_right(starts[tid], t) - 1
            if i >= 0 and merged[tid][i][1] >= t:
                count += 1
                seconds += dur / 1e6
        return count, seconds

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the longest idle
        gaps of the device by the host operator running at their middle."""
        by_name = defaultdict(float)
        for name, _, dur, _, _ in self.device_ops:
            by_name[name[:NAME_CHARS]] += dur / 1e6
        busy = self.busy_intervals()
        edges = [self.window_start] + [x for iv in busy for x in iv] + [self.window_end]
        gaps = defaultdict(float)
        host = sorted((s, s + d, name) for name, s, d, tid in self.host_ops
                      if tid == self.main_tid and name != WINDOW_NAME)
        spans = sorted((a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a)
        # One sweep: the host's operators on one thread nest, so the
        # innermost one running at a time is the top of a stack.
        stack, i = [], 0
        for a, b in spans:
            mid = (a + b) / 2
            while i < len(host) and host[i][0] <= mid:
                while stack and stack[-1][1] < host[i][0]:
                    stack.pop()
                stack.append(host[i])
                i += 1
            while stack and stack[-1][1] < mid:
                stack.pop()
            gaps[stack[-1][2] if stack else "host, outside any operator"] += (b - a) / 1e6
        rank = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]
        return {"device_ops": rank(by_name), "idle_gaps": rank(gaps)}


def capture(fn: Callable[[], dict], device: torch.device) -> Tuple[Optional[Trace], dict]:
    """Runs `fn` under the profiler inside the ``portbench.traced`` range,
    synchronised at its end. Returns the trace and what `fn` returned."""
    from torch.profiler import ProfilerActivity, profile, record_function

    cuda = device.type == "cuda"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=activities) as prof:
        with record_function(WINDOW_NAME):
            out = fn()
            if cuda:
                torch.cuda.synchronize(device)
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    return Trace(events), out
