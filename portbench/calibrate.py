"""The readings that the limits of ``correct`` are set from, on the chip:
the numbers that the cell's driver compares, through its own ``compare``,
for the program over many seeds and for the control, which is the plain
reference computed in TF32 (the precision below the configurations' fp32)
put in the program's place. For the training cell also a planted fault:
half of the batch left out of the loss, the mean taken over the rest, in
the reference put in the program's place.

    python -m portbench.calibrate --workload door_pf.fused_n16 \\
        --seeds 101-112 --control-seeds 101-103 --seconds 3

One process, so set-up's fixed costs are paid once; each seed builds its
model, weights and inputs anew and runs a short window at the cell's own
sizes and load. Prints one JSON line per seed.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import sys
import time

import torch

from portbench import harness
from portbench.reference import filters
from portbench.run import ROOT


@contextlib.contextmanager
def tf32():
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def seeds(text: str):
    out = []
    for part in text.split(","):
        lo, _, hi = part.partition("-")
        out += list(range(int(lo), int(hi or lo) + 1))
    return out


def judged(checks) -> dict:
    """The compared numbers by name, and whether all are within limits."""
    return {"correct": all(value <= limit for _, value, limit in checks),
            **{name: value for name, value, _ in checks}}


def calibrate_eval(driver, run, seconds: float, control: bool) -> dict:
    state = driver.setup(run)
    window = driver.window(state, seconds)
    out = {"requests": window["requests"], "program": judged(driver.check(state))}
    if control:
        with tf32():
            low = [driver.reference_estimates(run, state.weights, x, j)[0]
                   for j, x in enumerate(state.pool)]
        out["control_tf32"] = judged(driver.compare(
            state, {i: low[i % len(low)] for i in state.estimates}))
    return out


def _half_batch_loss(w, cfg, states, controls, obs, eps0, eps_seq, scale):
    half = states.shape[0] // 2
    t, d = eps_seq.shape[0], eps_seq.shape[-1]
    return filters.e2e_loss(w, cfg, states[:half], controls[:half],
                            {k: v[:half] for k, v in obs.items()}, eps0[:half],
                            eps_seq.reshape(t, states.shape[0], -1, d)[:, :half].reshape(t, -1, d),
                            scale)


def calibrate_train(driver, run, seconds: float, control: bool) -> dict:
    state = driver.setup(run)
    window = driver.window(state, seconds)
    got = driver.program_readings(state)
    driver.release(state)
    ref = driver.reference_readings(state)
    worst = {name: max(max(driver.leaf_gaps(a, b, driver.moved(b)).values())
                       for a, b in zip(got_, ref_))
             for name, got_, ref_ in (
                 ("grad_first", [got.first_grads], [ref.first_grads]),
                 ("update_first", [got.first_updates], [ref.first_updates]),
                 ("grad_last", got.last_grads, ref.last_grads))}
    steps = [driver.median_leaf_gap(a, b, b) for a, b in zip(got.last_grads, ref.last_grads)]
    out = {"optimizer_steps": window["optimizer_steps"],
           "program": judged(driver.compare(state, got, ref)), "worst_leaf": worst,
           "loss_gaps": [abs(a - b) / abs(b) for a, b in zip(got.first_losses, ref.first_losses)],
           "grad_gaps_last_epoch": steps,
           "reference_again": judged(driver.compare(state, driver.reference_readings(state), ref))}
    if control:
        with tf32():
            out["control_tf32"] = judged(driver.compare(state, driver.reference_readings(state),
                                                        ref))
        out["fault_half_batch"] = judged(driver.compare(
            state, driver.reference_readings(state, loss_fn=_half_batch_loss), ref))
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--control-seeds", default="")
    parser.add_argument("--seconds", type=float, default=3.0)
    args = parser.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    if not torch.cuda.is_available():
        print("portbench.calibrate: CUDA is not available", file=sys.stderr)
        return 2
    cell = harness.resolve(ROOT, args.workload)
    driver = harness.load_file_module(cell.driver_path, "portbench_calibrate_driver")
    control = set(seeds(args.control_seeds)) if args.control_seeds else set()
    fn = calibrate_train if cell.traffic["driver"] == "train_e2e" else calibrate_eval
    for seed in seeds(args.seeds):
        t0 = time.perf_counter()
        run = harness.Run(cell, seed, torch.device("cuda", 0))
        out = fn(driver, run, args.seconds, seed in control)
        out = {"workload": args.workload, "seed": seed,
               "seconds": round(time.perf_counter() - t0, 1), **out}
        print(json.dumps(out, default=lambda x: None if math.isnan(x) else x), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
