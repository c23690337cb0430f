"""Eval requests through the facade, closed loop, one client.

A request is what a user of ``StatefulFilter`` does to filter a batch:
``initialize_beliefs(mean=, covariance=)`` (the facade draws the initial
particles from its generator, seeded for each entry of the pool from the
run's seed), then ``forward_loop(observations=, controls=, eps_seq=,
uniforms_seq=)`` with the loop's draws made by the benchmark, ended by a
synchronise on the estimates. Requests cycle over a pool of inputs made at
set-up on the device. The mix's ``knobs`` are the serving switches the
facade reads from the environment when it is built.

``correct``: every request the window finished is compared, at every step
and trajectory, with the plain reference's estimates of its pool entry.
A resampling uniform within rounding of a CDF entry may draw the
neighbouring slot on one side and not the other, and from there the two
sides' particles part although both are right; so set-up runs the
reference once over each pool entry and draws again every uniform closer
than ``MARGIN`` to an entry of its step's CDF (the reference's time and
memory are not the program's: set-up's clock leaves it out and the memory
peak is reset after it).
"""

from __future__ import annotations

import dataclasses
import statistics
import time

import torch
from torch.profiler import record_function

from portbench import inputs, program
from portbench.reference import filters

# Sound runs parted from the reference at uniforms within 1e-6 of a CDF
# entry, and later in a request, as rounding grows over its steps, farther
# (PERF.md); the margin keeps every draw a hundred times farther.
MARGIN = 1e-4


@dataclasses.dataclass
class State:
    run: object
    model: object
    weights: dict
    pool: list
    reference: list
    reference_s: float
    next_index: int = 0
    estimates: dict = dataclasses.field(default_factory=dict)


def request_seed(run, index: int) -> int:
    """The seed of the facade's generator for request `index`: its pool
    entry's, so that every request of an entry draws the same particles."""
    return inputs.stream_seed(run.seed, f"request{index % run.traffic['pool']}")


def request(state: State, index: int):
    """Sends request `index`; returns its estimates (not synchronised)."""
    x = state.pool[index % len(state.pool)]
    model = state.model
    model.generator.manual_seed(request_seed(state.run, index))
    model.initialize_beliefs(mean=x["mean"], covariance=x["cov"])
    return model.forward_loop(observations=x["obs"], controls=x["controls"],
                              eps_seq=x["eps_seq"], uniforms_seq=x["uniforms"])


def reference_estimates(run, weights, x, j: int, margin: float = 0.0):
    """The reference's estimates (T, N, D) of pool entry `j` with inputs
    `x`, and the uniforms it drew with (drawn again from the seed where
    closer than `margin` to a CDF entry)."""
    n, m, d = run.traffic["N"], run.traffic["M"], run.config["state_dim"]
    # The facade's draw of the initial particles, made again from its seed.
    g = torch.Generator(device=run.device).manual_seed(request_seed(run, j))
    eps0 = torch.randn((n, m, d), generator=g, device=run.device)
    with torch.no_grad():
        return filters.eval_loop(weights, run.config, x["obs"], x["controls"], x["mean"],
                                 x["cov"], eps0, x["eps_seq"], x["uniforms"], margin=margin,
                                 redraw=inputs.generator(run.seed, f"redraw{j}", run.device))


def setup(run) -> State:
    model, weights = program.build_model(run)
    model.eval()
    traffic = run.traffic
    pool = [inputs.eval_request_inputs(run.config, traffic, run.seed, j, run.device)
            for j in range(traffic["pool"])]
    t0 = time.perf_counter()
    reference = []
    for j, x in enumerate(pool):
        estimates, x["uniforms"] = reference_estimates(run, weights, x, j, MARGIN)
        reference.append(estimates)
    if run.device.type == "cuda":
        torch.cuda.synchronize(run.device)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(run.device)
    state = State(run, model, weights, pool, reference, time.perf_counter() - t0)
    # Warm-up: every shape the window uses (one shape; the kernels' build,
    # cuDNN's first calls). Negative indices: never checked.
    for i in range(traffic["warm_requests"]):
        request(state, -1 - i)
    return state


def _sync(state):
    if state.run.device.type == "cuda":
        torch.cuda.synchronize(state.run.device)


def window(state: State, seconds: float) -> dict:
    """Closed loop for `seconds`: the request under way when time is up
    completes and counts. The rate is reported under the mix's
    ``rate_metric`` (``filter_steps_per_s`` where it names none)."""
    t, n = state.run.traffic["T"], state.run.traffic["N"]
    spans = []
    start = time.perf_counter()
    while True:
        t0 = time.perf_counter()
        est = request(state, state.next_index)
        t1 = time.perf_counter()
        _sync(state)
        t2 = time.perf_counter()
        spans.append((t0, t1, t2))
        state.estimates[state.next_index] = est
        state.next_index += 1
        if t2 - start >= seconds:
            break
    elapsed = spans[-1][2] - start
    latencies_ms = [(c - a) * 1e3 for a, _, c in spans]
    p95 = (statistics.quantiles(latencies_ms, n=20, method="inclusive")[18]
           if len(latencies_ms) > 1 else latencies_ms[0])
    rate = state.run.traffic.get("rate_metric", "filter_steps_per_s")
    e2e = {rate: len(spans) * n * t / elapsed, "request_p95_ms": p95}
    return {"e2e": e2e, "attempted": len(spans), "failed": 0, "window_s": elapsed,
            "requests": len(spans), "spans": spans}


def traced(state: State) -> dict:
    """A fixed number of requests, each in its own range; not checked."""
    k = state.run.traffic["trace_requests"]
    for i in range(k):
        with record_function("portbench.request"):
            request(state, -1000 - i)
            _sync(state)
    return {"requests": k, "steps": k * state.run.traffic["T"]}


def relative_errors(got, ref):
    """Per step and trajectory (T, N): the largest error of the estimate
    over the request's scale (its largest reference estimate, at least 1);
    a non-finite estimate errs infinitely."""
    scale = max(1.0, float(ref.abs().max()))
    err = (got - ref).abs().amax(dim=-1) / scale
    return torch.where(torch.isfinite(err), err, torch.full_like(err, float("inf")))


def compare(state: State, estimates: dict) -> list:
    """(name, value, limit): the largest relative error over every step and
    trajectory of the requests `estimates` (index -> (T, N, D))."""
    pool = len(state.pool)
    worst = max(float(relative_errors(est, state.reference[i % pool]).max())
                for i, est in estimates.items())
    return [("est_err_max", worst, state.run.cell.limits["est_err_max"])]


def check(state: State) -> list:
    state.model = None
    if state.run.device.type == "cuda":
        torch.cuda.empty_cache()
    return compare(state, state.estimates)
