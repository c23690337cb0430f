"""One run of one cell: resolve it from ``BENCHMARK.json`` and the files it
names, set up, measure, trace, check, and build the result line.

A cell is ``config`` x ``traffic``. Every part is a file found by name
under the benchmark's folder, so a later cell, mix or metric is new files
and new entries, never an edit:

  portbench/configs/<config>.json        the model and its widths
  portbench/traffic/<traffic>.json       the driver and the mix's sizes
  portbench/drivers/<driver>.py          setup, window, traced, check
  portbench/layer_metrics/<metric>.py    read(ctx) -> number or None
  portbench/limits/<cell>.json           the limits of what ``correct`` compares

A driver module defines ``setup(run) -> state``, ``window(state, seconds)
-> {"e2e": {...}, "attempted": n, "failed": n}``, ``traced(state) ->
{work}`` and ``check(state) -> [(name, value, limit)]``; ``check`` frees
the program's state before the reference runs. A state may carry
``reference_s``, the seconds of set-up that the reference took.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

import torch

from . import counts
from . import trace as trace_mod

FORBIDDEN_TOP_LEVEL = ("jax", "jaxlib", "flax", "optax", "multimodalfilter_tpu", "crossmodal")
PACKAGE = "portbench"


def forbidden_modules() -> List[str]:
    """Top-level names in ``sys.modules`` that the benchmark may not load,
    compared whole (``multimodalfilter_tpu_torch`` is not
    ``multimodalfilter_tpu``)."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN_TOP_LEVEL))


def load_file_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module  # dataclasses look their module up by name
    spec.loader.exec_module(module)
    return module


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    limits: Dict[str, float]
    end_to_end: List[dict]
    per_layer: List[dict]
    driver_path: Path
    reader_paths: Dict[str, Path]


def resolve(root: Path, workload: str) -> Cell:
    """The cell `workload` of the benchmark rooted at `root` (the folder
    that holds ``BENCHMARK.json``)."""
    root = Path(root)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r}; known: {sorted(cells)}")
    cell = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / configs[cell["config"]]["file"]).read_text())
    base = root / PACKAGE
    traffic = json.loads((base / "traffic" / f"{cell['traffic']}.json").read_text())
    limits = json.loads((base / "limits" / f"{workload}.json").read_text())

    def applies(metric) -> bool:
        return workload in metric.get("workloads", [workload])

    e2e = [m for m in bench["end_to_end"] if applies(m)]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if m["moves"] in e2e_names and applies(m)]
    return Cell(
        name=workload, chips=int(cell["chips"]), config=config, traffic=traffic, limits=limits,
        end_to_end=e2e, per_layer=per_layer,
        driver_path=base / "drivers" / f"{traffic['driver']}.py",
        reader_paths={m["name"]: base / "layer_metrics" / f"{m['name']}.py"
                      for m in per_layer},
    )


@dataclasses.dataclass
class Run:
    """What a driver's ``setup`` gets."""

    cell: Cell
    seed: int
    device: torch.device

    @property
    def config(self):
        return self.cell.config

    @property
    def traffic(self):
        return self.cell.traffic


@dataclasses.dataclass
class ReaderContext:
    """What a per-layer reader gets: the traced segment (None when the
    run was not traced), the window's spans and what the drivers counted,
    the cell's configuration and mix, and the yardstick."""

    trace: Optional[trace_mod.Trace]
    window: Dict[str, Any]
    work: Dict[str, Any]
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    counts: Any = counts


def synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def device_info(device: torch.device) -> Dict[str, Any]:
    if device.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1,
                "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}
    return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}


def run_cell(root: Path, workload: str, seed: int, seconds: float, traced: bool,
             device: torch.device, started: float) -> Dict[str, Any]:
    """One run; `started` is the process's start on ``time.perf_counter``.
    Returns the result line's object (its ``checks`` last)."""
    cell = resolve(root, workload)
    driver = load_file_module(cell.driver_path, f"{PACKAGE}_driver_{cell.traffic['driver']}")
    state = driver.setup(Run(cell, seed, device))
    synchronize(device)
    # Whatever the reference computes in set-up is the check's, not the
    # program's: the driver's ``reference_s`` is left out of set-up.
    setup_s = time.perf_counter() - started - getattr(state, "reference_s", 0.0)

    t0 = time.perf_counter()
    window = driver.window(state, seconds)
    t1 = time.perf_counter()
    trace, work = None, {}
    if traced:
        trace, work = trace_mod.capture(lambda: driver.traced(state), device)
    t2 = time.perf_counter()
    info = device_info(device)
    checks = driver.check(state)
    print(f"portbench: setup {setup_s:.2f} s, window {t1 - t0:.2f} s, traced segment and its "
          f"reading {t2 - t1:.2f} s, check {time.perf_counter() - t2:.2f} s", file=sys.stderr)
    correct = all(value <= limit for _, value, limit in checks)

    measured = dict(window["e2e"], setup_s=setup_s)
    result: Dict[str, Any] = {"correct": correct, "attempted": window["attempted"],
                              "failed": window["failed"]}
    if not traced:
        result["metrics"] = {m["name"]: {"value": measured[m["name"]], "unit": m["unit"]}
                             for m in cell.end_to_end}
    else:
        ctx = ReaderContext(trace=trace, window=window, work=work, config=cell.config,
                            traffic=cell.traffic)
        metrics = {}
        for m in cell.per_layer:
            reader = load_file_module(cell.reader_paths[m["name"]],
                                      f"{PACKAGE}_metric_{len(metrics)}")
            value = reader.read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        result["metrics"] = metrics
        if trace is not None:
            info["busy_s"] = trace.busy_s
            info["window_s"] = trace.window_s
    result["device"] = info
    if trace is not None:
        result["breakdown"] = trace.breakdown()
    result["checks"] = {name: {"value": value, "limit": limit} for name, value, limit in checks}
    return result
