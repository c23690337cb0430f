"""Run one cell of the benchmark once and print its result line.

    python -m portbench.run --workload door_pf.fused_n16 --seed 7 \\
        --seconds 10 --trace 0

From the root of a checkout, on a machine with the cards the cell asks
for: set up (build the model, load weights made from the seed, make the
inputs, warm up), measure for ``--seconds``, with ``--trace 1`` trace a
fixed segment after the window, check the window's output against the
plain reference, and print one JSON object as the last line of standard
output (the compared numbers and their limits also as the last lines of
standard error). ``--trace 0`` reports the cell's end-to-end metrics,
``--trace 1`` its per-layer metrics.

Exits non-zero, printing no result, without CUDA or the cards the cell
asks for, when the program is not the checkout's own, or when JAX or the
JAX package was loaded.
"""

from __future__ import annotations

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# Fixed directories inside the checkout for whatever compiles: the
# program's nvcc builds already go to ROOT/build (ops/_build.py).
CACHE_DIRS = {"TRITON_CACHE_DIR": ROOT / "build" / "triton",
              "TORCH_EXTENSIONS_DIR": ROOT / "build" / "torch_extensions"}


def _fail(message: str) -> int:
    print(f"portbench: {message}", file=sys.stderr)
    return 2


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    for key, path in CACHE_DIRS.items():
        os.environ[key] = str(path)

    import torch

    from portbench import harness

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = harness.resolve(ROOT, args.workload)
    if not torch.cuda.is_available():
        return _fail("CUDA is not available")
    if torch.cuda.device_count() < cell.chips:
        return _fail(f"{args.workload} needs {cell.chips} cards, "
                     f"{torch.cuda.device_count()} visible")
    package = cell.config["model"].split(".")[0]
    spec = importlib.util.find_spec(package)
    if spec is None or spec.origin is None or ROOT not in Path(spec.origin).resolve().parents:
        return _fail(f"the program {package} is not in this checkout ({ROOT})")

    result = harness.run_cell(ROOT, args.workload, args.seed, args.seconds,
                              bool(args.trace), torch.device("cuda", 0), STARTED)
    loaded = harness.forbidden_modules()
    if loaded:
        return _fail(f"modules of JAX or the JAX package were loaded: {loaded}")
    for name, check in result["checks"].items():
        print(f"check {name}: {check['value']!r} (limit {check['limit']!r})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
