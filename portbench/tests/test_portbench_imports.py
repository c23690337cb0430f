"""What the benchmark loads: no module of JAX or of the JAX package
(top-level names compared whole: ``multimodalfilter_tpu_torch`` is allowed,
``multimodalfilter_tpu`` is not), and nothing of the program in the
reference. A run without a card exits non-zero and prints no result."""

from __future__ import annotations

import ast
import json
import subprocess
import sys

import pytest

from portbench import harness

from .conftest import ROOT

BENCH_DIR = ROOT / "portbench"
SOURCES = [p for p in BENCH_DIR.rglob("*.py") if "tests" not in p.parts]


def _imported_top_levels(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {alias.name.split(".")[0] for alias in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_forbidden_names_are_compared_whole(monkeypatch):
    for name in ("multimodalfilter_tpu_torch", "multimodalfilter_tpu_torch.ops", "crossmodalx"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "multimodalfilter_tpu.filtering", sys)
    monkeypatch.setitem(sys.modules, "jaxlib", sys)
    assert harness.forbidden_modules() == ["jaxlib", "multimodalfilter_tpu"]


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_sources_import_nothing_of_jax(path):
    assert not _imported_top_levels(path) & set(harness.FORBIDDEN_TOP_LEVEL)
    if "reference" in path.parts:
        assert "multimodalfilter_tpu_torch" not in path.read_text()


def test_a_run_loads_nothing_of_jax(small_root):
    code = (
        "import json, sys, time, torch\n"
        "from portbench import harness\n"
        f"harness.run_cell({str(small_root)!r}, 'door_pf.train_b32', 3, 0.1, True,\n"
        "                 torch.device('cpu'), time.perf_counter())\n"
        f"harness.run_cell({str(small_root)!r}, 'push_pf.stepwise_n256', 3, 0.1, True,\n"
        "                 torch.device('cpu'), time.perf_counter())\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=300, check=True)
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "multimodalfilter_tpu_torch" in loaded
    assert not loaded & set(harness.FORBIDDEN_TOP_LEVEL)


def test_no_result_without_a_card(tmp_path):
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                          "door_pf.fused_n16", "--seed", str(2**31 + 5), "--seconds", "1",
                          "--trace", "0"], cwd=ROOT, capture_output=True, text=True, timeout=120,
                         env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": "",
                              "HOME": str(tmp_path)})
    assert out.returncode != 0
    assert out.stdout.strip() == ""
