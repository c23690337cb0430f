"""Run every registry class's training curriculum and eval through the task
CLIs, on synthetic data (port of ``scripts/validate_curricula.py``).

    python -m multimodalfilter_tpu_torch.scripts.validate_curricula            # all 20
    python -m multimodalfilter_tpu_torch.scripts.validate_curricula PushKalmanFilter ...
        [--device cuda] [--synth-traj 8] [--synth-t 100] [--timeout 3600]
        [--workdir DIR] [--out FILE]

Each class of ``DoorTask.model_types`` and ``PushTask.model_types`` trains
through its task's train CLI (``train_door``/``train_push``, so every branch
of its curriculum runs, the warm-start fallbacks included), in a subprocess,
then its checkpoint is evaluated by the eval CLI (``--save``), in another.
The datasets are synthesised in memory (``MMF_TPU_SYNTHESIZE_DATA=1``, with
``--synth-traj`` trajectories of ``--synth-t`` steps) and nothing is
downloaded (``MMF_TPU_OFFLINE=1``). ``--timeout`` bounds each class's train
and eval together. One JSON line a class is appended to ``--out``: its wall
times, whether each part succeeded (the tail of its output if not) and the
eval's RMSE statistics. Checkpoints and metadata go under ``--workdir``
(default: the repository root, whose ``checkpoints/`` and ``metadata/`` git
ignores).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

REPO = Path(__file__).resolve().parents[2]
PACKAGE = "multimodalfilter_tpu_torch.scripts"


def registry_classes() -> List[str]:
    """The door classes, then the push classes, by registry order."""
    from ..crossmodal import door_models, push_models  # noqa: F401  (registers them)
    from ..crossmodal.tasks import DoorTask, PushTask

    return [*DoorTask.model_types, *PushTask.model_types]


def commands(model: str, experiment: str, device: str) -> Dict[str, List[str]]:
    """The train and eval commands of `model` (the door CLIs for a Door*
    class, the push CLIs otherwise)."""
    task = "door" if model.startswith("Door") else "push"
    module = f"{PACKAGE}.{task}_task"
    return {
        "train": [sys.executable, "-u", "-m", f"{module}.train_{task}", "--model-type", model,
                  "--experiment-name", experiment, "--device", device],
        "eval": [sys.executable, "-u", "-m", f"{module}.eval_{task}", "--experiment-name",
                 experiment, "--device", device, "--save"],
    }


def run_one(model: str, *, out: str, device: str = "cuda", synth_traj: int = 8,
            synth_t: int = 100, timeout: float = 3600.0,
            workdir: Optional[str] = None) -> dict:
    """Train and evaluate `model` in subprocesses, within `timeout` seconds
    in all; append its JSON line to `out` and return it."""
    workdir = str(workdir or REPO)
    experiment = f"validate_{model}"
    env = {**os.environ, "MMF_TPU_SYNTHESIZE_DATA": "1", "MMF_TPU_SYNTH_TRAJ": str(synth_traj),
           "MMF_TPU_SYNTH_T": str(synth_t), "MMF_TPU_OFFLINE": "1",
           "PYTHONPATH": os.pathsep.join(filter(None, [str(REPO),
                                                       os.environ.get("PYTHONPATH")]))}
    rec: dict = {"model": model, "device": device, "synth_traj": synth_traj,
                 "synth_t": synth_t}
    start = time.perf_counter()
    for part, cmd in commands(model, experiment, device).items():
        left = timeout - (time.perf_counter() - start)
        t0 = time.perf_counter()
        try:
            proc = subprocess.run(cmd, env=env, cwd=workdir, capture_output=True, text=True,
                                  timeout=max(left, 1.0))
        except subprocess.TimeoutExpired:
            rec.update({f"{part}_ok": False, f"{part}_s": time.perf_counter() - t0,
                        "error": f"{part} passed the time limit of {timeout} s"})
            break
        rec[f"{part}_s"] = time.perf_counter() - t0
        rec[f"{part}_ok"] = proc.returncode == 0
        if proc.returncode != 0:
            rec[f"{part}_tail"] = (proc.stdout + proc.stderr)[-2000:]
            break
    if rec.get("eval_ok"):
        with open(os.path.join(workdir, "metadata", f"{experiment}.json")) as f:
            stats = json.load(f)["eval_results_stats"]
        rec["rmse"] = {k: v for k, v in stats.items() if "rmse" in k}
    rec["ok"] = bool(rec.get("train_ok") and rec.get("eval_ok"))
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "a") as f:
        f.write(json.dumps(rec) + "\n")
    return rec


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("models", nargs="*", help="classes to run (default: all 20)")
    parser.add_argument("--all", action="store_true", help="all 20 classes (the default)")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--synth-traj", type=int, default=8)
    parser.add_argument("--synth-t", type=int, default=100)
    parser.add_argument("--timeout", type=float, default=3600.0,
                        help="seconds for each class's train and eval together")
    parser.add_argument("--workdir", default=None)
    parser.add_argument("--out", default=str(REPO / ".scratch" / "curricula_validation.jsonl"))
    args = parser.parse_args(argv)

    known = registry_classes()
    models = known if args.all or not args.models else args.models
    unknown = sorted(set(models) - set(known))
    if unknown:
        parser.error(f"not a registry class: {', '.join(unknown)}")
    failures = 0
    for model in models:
        print(f"=== {model} ===", flush=True)
        rec = run_one(model, out=args.out, device=args.device, synth_traj=args.synth_traj,
                      synth_t=args.synth_t, timeout=args.timeout, workdir=args.workdir)
        failures += not rec["ok"]
        print(json.dumps(rec)[:600], flush=True)
    print(f"done: {len(models) - failures}/{len(models)} OK -> {args.out}")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
