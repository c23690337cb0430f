"""Shared pieces of the benchmark's tests: the ``gpu`` marker (a card test
skips inside its fixture without one), and copies of the benchmark in a
temporary directory, one whose mixes are cut to sizes a CPU runs in
seconds. Both copies carry the parked cells (``portbench/parked/``) back in
their ``BENCHMARK.json``, as a later PR that brings such a cell back adds
them, so the parked drivers stay tested.

    python -m pytest portbench/tests -q                   # on the CPU
    python -m pytest portbench/tests -q -m gpu            # on a card
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
PARKED = ROOT / "portbench" / "parked"
PARKED_CELLS = [w["name"] for path in sorted(PARKED.glob("*.json"))
                for w in json.loads(path.read_text())["workloads"]]
# Each mix cut to a few steps, trajectories and particles; every width is
# the configuration's own.
SMALL = {"fused_n16": {"N": 3, "T": 6, "M": 40, "pool": 2, "warm_requests": 1,
                       "trace_requests": 1},
         "stepwise_n256": {"N": 4, "T": 5, "M": 24, "pool": 2, "warm_requests": 1,
                           "trace_requests": 1},
         "train_b32": {"B": 4, "L": 4, "M": 5, "subsequences": 16, "trace_steps": 1}}
# The chip's limits are set from the card's readings at the cells' sizes;
# on the CPU the two sides sum in yet other orders, so the tests hold a
# sound run to these, still far below what every fault reads (above 1e-3).
CPU_LIMITS = {"est_err_max": 1e-5,
              "loss_gap_first_step": 1e-5, "grad_norm_gap_median_leaf": 1e-4,
              "update_norm_gap_median_leaf": 1e-3, "grad_norm_gap_median_leaf_last_epoch": 1e-4}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card; skipped (inside a fixture) without one")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def with_parked(bench: dict) -> dict:
    """`bench` with every parked cell's entries added back."""
    bench = json.loads(json.dumps(bench))
    for path in sorted(PARKED.glob("*.json")):
        parked = json.loads(path.read_text())
        for group in ("workloads", "end_to_end", "per_layer"):
            bench[group] += parked[group]
    return bench


@pytest.fixture
def full_root(tmp_path) -> Path:
    """The benchmark copied under tmp_path as it is, the parked cells back."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(with_parked(bench)))
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    return tmp_path


@pytest.fixture
def small_root(full_root) -> Path:
    """The benchmark copied under tmp_path with small mixes and CPU limits."""
    for name, sizes in SMALL.items():
        path = full_root / "portbench" / "traffic" / f"{name}.json"
        path.write_text(json.dumps({**json.loads(path.read_text()), **sizes}))
    for path in (full_root / "portbench" / "limits").glob("*.json"):
        path.write_text(json.dumps({k: CPU_LIMITS[k] for k in json.loads(path.read_text())}))
    return full_root
