"""Eval throughput instrumentation (port of ``crossmodal/_eval_throughput.py``).

  - ``device_throughput``: `chain` dependent forward_loops, the belief
    threaded through, timed with CUDA events on the card (``perf_counter`` on
    the CPU). Eager PyTorch launches every kernel from the host, so the
    figure includes host dispatch: the card waits on the host between
    kernels.
  - ``warm_up_loop``: keeps the first run of a loop configuration on the
    card (the kernels' build and cuDNN's first calls) out of the timed run.
"""

from __future__ import annotations

import time

import torch

from . import _eval_state as S

CHAIN_SEED = 997  # the chained loops' draws, apart from the facade's stream


def warm_up_loop(filter_model, obs_rest, controls_rest, batch: int) -> None:
    """One discarded forward_loop, run only on the card and only if this
    (mode, enabled, batch, def) configuration has not run yet. The belief is
    restored, so the timed run that follows starts where it would have. (The
    CPU has no kernel build or first-call cost to keep out.)"""
    if (filter_model.device.type == "cuda"
            and filter_model.loop_cache_key(batch) not in filter_model._loops_run):
        saved_belief = filter_model.belief
        filter_model.forward_loop(observations=obs_rest, controls=controls_rest).cpu()
        filter_model.belief = saved_belief


def _seconds(fn, device: torch.device) -> float:
    if device.type != "cuda":
        start = time.perf_counter()
        fn()
        return time.perf_counter() - start
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3


def device_throughput(observations, controls, states, chain: int = 4) -> float:
    """Filter-steps/s of `chain` dependent forward_loops from the current
    belief: the best of 3 timed runs after two warm ones, each run drawing
    its own noise from a generator of its own (the facade's stream is left
    as it was). (T-1)*N*chain steps a run.

    The loops are the configured ones (``StatefulFilter.run_loop``): on a
    mesh, data-parallel or pipelined, with T padded to the stage count as
    ``forward_loop`` pads it, and the steps counted are the (T-1)*N useful
    ones, so the padding's cost is billed.

    The JAX package perturbs each chained loop's inputs by i*1e-12 so that
    XLA cannot hoist the encoders out of its chained program; eager PyTorch
    hoists nothing, so the inputs are passed as they are."""
    filter_model = S.filter_model
    device = filter_model.device
    t, n = states.shape[:2]
    obs_rest = {k: v[1:] for k, v in observations.items()}
    ctrl_rest = controls[1:]
    belief = filter_model.belief
    generator = torch.Generator(device=device)

    def chained(seed: int) -> None:
        generator.manual_seed(seed)
        b = belief
        with torch.no_grad():
            for _ in range(chain):
                b, est = filter_model.run_loop(b, obs_rest, ctrl_rest,
                                               generator=generator)
        float(est.sum())

    chained(CHAIN_SEED)
    chained(CHAIN_SEED + 1)
    best = min(_seconds(lambda i=i: chained(CHAIN_SEED + 3 + i), device) for i in range(3))
    return float((t - 1) * n * chain / best)
