"""The harness is driven by data: every cell of ``BENCHMARK.json``, and
every parked cell once its entries are back, resolves and runs end to end
(here on the CPU, at small sizes), and a cell whose
configuration, traffic mix and per-layer reader exist only as files added
beside the others runs without an edit to any file already there."""

from __future__ import annotations

import json
import re
import time

import pytest
import torch

from portbench import harness

from .conftest import PARKED_CELLS, ROOT, with_parked

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]


def _run(root, cell, traced):
    return harness.run_cell(root, cell, 2**31 + 123, 0.2, traced, torch.device("cpu"),
                            time.perf_counter())


@pytest.mark.parametrize("cell", CELLS + PARKED_CELLS)
def test_every_cell_resolves_and_runs(small_root, cell):
    resolved = harness.resolve(small_root, cell)
    assert resolved.chips == 1 and resolved.driver_path.exists()
    assert all(p.exists() for p in resolved.reader_paths.values())
    assert {m["name"] for m in resolved.end_to_end} >= {"setup_s"}
    result = _run(small_root, cell, traced=False)
    assert result["correct"] is True, result["checks"]
    assert set(result["metrics"]) == {m["name"] for m in resolved.end_to_end}
    assert list(result)[-1] == "checks"
    traced = _run(small_root, cell, traced=True)
    assert traced["correct"] is True
    assert set(traced["metrics"]) <= {m["name"] for m in resolved.per_layer}
    assert traced["device"]["window_s"] > 0


def test_a_cell_added_as_files_only(small_root):
    base = small_root / "portbench"
    config = json.loads((base / "configs" / "door_crossmodal_pf.json").read_text())
    config["name"] = "door_crossmodal_pf_copy"
    (base / "configs" / "door_crossmodal_pf_copy.json").write_text(json.dumps(config))
    (base / "traffic" / "tiny_fused.json").write_text(json.dumps({
        "driver": "eval_loop", "knobs": {"MMF_TPU_FUSED_STEP": "1"}, "N": 2, "T": 3, "M": 16,
        "pool": 1, "initial_cov_scale": 0.1, "warm_requests": 1, "trace_requests": 2}))
    (base / "layer_metrics" / "requests_traced.py").write_text(
        "def read(ctx):\n    return ctx.work.get('requests')\n")
    (base / "limits" / "tiny.fused.json").write_text(
        (base / "limits" / "door_pf.fused_n16.json").read_text())
    bench = json.loads((small_root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "door_crossmodal_pf_copy", "source": "x",
                             "file": "portbench/configs/door_crossmodal_pf_copy.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "tiny.fused", "config": "door_crossmodal_pf_copy",
                               "traffic": "tiny_fused", "chips": 1, "why": "x"})
    next(m for m in bench["end_to_end"]
         if m["name"] == "filter_steps_per_s")["workloads"].append("tiny.fused")
    bench["per_layer"].append({"name": "requests_traced", "unit": "requests", "better": "higher",
                               "source": "program_counter", "layer": "x",
                               "moves": "filter_steps_per_s", "workloads": ["tiny.fused"]})
    (small_root / "BENCHMARK.json").write_text(json.dumps(bench))

    result = _run(small_root, "tiny.fused", traced=True)
    assert result["correct"] is True
    assert result["metrics"]["requests_traced"] == {"value": 2, "unit": "requests"}
    assert "host_ms_per_request.eval" not in result["metrics"]  # not listed for the new cell
    assert set(_run(small_root, "tiny.fused", traced=False)["metrics"]) == {
        "filter_steps_per_s", "setup_s"}


NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"configs": {"name", "source", "file", "reduced", "why"},
        "workloads": {"name", "config", "traffic", "chips", "why"},
        "end_to_end": {"name", "unit", "better", "bound", "source"},
        "per_layer": {"name", "unit", "better", "source", "layer", "moves"}}


@pytest.mark.parametrize("bench", [BENCH, with_parked(BENCH)], ids=["as_is", "parked_back"])
def test_benchmark_json_keeps_its_form(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["paths"] == ["portbench"] and 1 <= bench["run_seconds"] <= 51
    for group, keys in KEYS.items():
        names = [entry["name"] for entry in bench[group]]
        assert len(names) == len(set(names))
        for entry in bench[group]:
            assert set(entry) - {"workloads"} == keys, entry["name"]
            assert NAME.match(entry["name"]), entry["name"]
            for text in ("why", "layer", "source"):
                assert 1 <= len(entry.get(text, "x")) <= 200 and "\n" not in entry.get(text, "")
            if "unit" in entry:
                assert UNIT.match(entry["unit"]) and entry["better"] in ("lower", "higher")
            if group == "configs":
                assert (ROOT / entry["file"]).exists() and entry["file"].startswith("portbench/")
            if group == "end_to_end":
                assert 0.01 <= entry["bound"] <= 0.25 and entry["source"] in ("host_clock",
                                                                            "device_trace")
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e and all(m["moves"] in e2e for m in bench["per_layer"])
    cells = {w["name"] for w in bench["workloads"]}
    assert all(set(m.get("workloads", cells)) <= cells
               for m in bench["end_to_end"] + bench["per_layer"])
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
