"""Evaluation helpers, the public API (port of ``crossmodal/eval_helpers.py``).

  - all eval trajectories batched, truncated to the common min length,
    stacked on axis 1 (``_eval_batching.get_eval_batch``);
  - beliefs initialized at ground-truth state[0] with 0.1*I covariance
    (``_eval_batching``);
  - one forward_loop over the whole sequence (here);
  - RMSE with the first 30 steps truncated, de-normalized with the dataset's
    hardcoded stddevs, in degrees and cm (``_eval_metrics``);
  - ``run_eval_stats``: mean and std over 20 stochastic repeats.

``run_eval`` returns two throughput figures:
  - ``filter_steps_per_sec``: chained dependent forward_loops timed with CUDA
    events (``_eval_throughput``). It includes the host's dispatch of every
    kernel. MMF_TPU_EVAL_DEVICE_THROUGHPUT=0 turns it off (it then repeats
    the e2e figure).
  - ``filter_steps_per_sec_e2e``: wall time of one forward_loop, including
    the copy of the estimates to the host.

The configured state (``buddy``, ``filter_model``, ``task``,
``dataset_args``) lives in ``_eval_state``; ``configure()`` mirrors it here.
"""

from __future__ import annotations

import os
import time
from typing import Dict, List

import numpy as np
import torch

from ..experiments import Buddy
from . import _eval_state as S
from . import tasks
from ._eval_batching import get_eval_batch as _get_eval_batch
from ._eval_batching import initialize_beliefs_for_eval
from ._eval_metrics import burn_in_truncation as _burn_in_truncation
from ._eval_metrics import metric_results as _metric_results
from ._eval_throughput import device_throughput as _device_throughput
from ._eval_throughput import warm_up_loop as _warm_up_loop

# Module globals, set by configure(); mirrored from _eval_state.
buddy: Buddy
filter_model = None
task = None
dataset_args: Dict = {}
mesh = None

# The shared cache object (tests clear and inspect it through this name).
_eval_batch_cache = S.batch_cache


def configure(*, buddy: Buddy, task, dataset_args: Dict, mesh=None,
              pipeline_mesh=None, pipeline_microbatches=None):
    """Set the model, task and dataset arguments of the eval.

    ``mesh`` (a "data" axis) splits the eval trajectories data-parallel:
    each rank filters its rows with the global draws, and the estimates are
    gathered in rank order, so the metrics are those of one device.
    ``pipeline_mesh`` instead runs the rollout through the temporal
    pipeline on its "pipe" axis (T padded to the stage count); a ("data",
    "pipe") grid combines the two, and a "particle" axis splits a PF's
    particles too. The two meshes are exclusive.
    ``pipeline_microbatches=None`` takes the largest divisor of the
    per-shard batch up to 8."""
    if not issubclass(task, tasks.Task):
        raise TypeError(f"{task} is not a Task")
    if mesh is not None and pipeline_mesh is not None:
        raise ValueError("mesh (data-parallel) and pipeline_mesh (pipelined) are exclusive")
    buddy.model.use_data_parallel(mesh)
    buddy.model.use_pipeline(pipeline_mesh, num_microbatches=pipeline_microbatches)
    S.set_state(buddy=buddy, task=task, dataset_args=dataset_args, mesh=mesh)
    for name in ("buddy", "filter_model", "task", "dataset_args", "mesh"):
        globals()[name] = getattr(S, name)


def log_eval(measurement_initialize=False) -> None:
    """Evaluate, print, and log metrics."""
    results = run_eval(measurement_initialize)
    with S.buddy.log_scope("eval"):
        for key, value in results.items():
            if type(value) == float:
                S.buddy.log_scalar(key, value)


def run_eval_stats(*eval_args, repeats: int = 20, **eval_kwargs) -> Dict[str, float]:
    """The reference's 20-repeat stochastic eval table: the mean and std of
    each metric over `repeats` runs. MMF_TPU_EVAL_BATCH_REPEATS=1 folds the
    repeats into the batch axis (``_batched_repeat_results``)."""
    batched = (
        os.environ.get("MMF_TPU_EVAL_BATCH_REPEATS", "0") == "1"
        and not eval_args
        and not eval_kwargs.get("eval_dynamics", False)
    )
    if batched:
        all_results = _batched_repeat_results(
            repeats,
            measurement_initialize=eval_kwargs.get("measurement_initialize", False),
        )
    else:
        all_results: Dict[str, List[float]] = {}
        for _ in range(repeats):
            results = run_eval(*eval_args, **eval_kwargs)
            results.pop("raw_rmse")
            for k, v in results.items():
                all_results.setdefault(k, []).append(float(v))

    results_stats = {}
    for k, v in all_results.items():
        results_stats[f"{k}_mean"] = float(np.array(v).mean())
        results_stats[f"{k}_std"] = float(np.array(v).std())
    for k, v in results_stats.items():
        print(f"{k}: {v}")
    return results_stats


def _batched_repeat_results(repeats: int,
                            measurement_initialize: bool = False) -> Dict[str, List[float]]:
    """run_eval_stats with the stochastic repeats folded into the batch axis:
    R repeats of the N trajectories run as one (T, N*R) rollout instead of R
    rollouts of N.

    Statistically the sequential path: each repeat's rows draw their own
    filter noise and, applied after tiling, their own blackout masks; but
    not its random stream. Per-repeat RMSEs come from slicing the batch back
    apart, so mean and std are over the same per-repeat statistics. The
    chained throughput is measured at the original batch, the e2e figure is
    the batched wall time.

    The repeats a rollout holds are capped so that N*R stays at or below
    MMF_TPU_EVAL_BATCH_REPEATS_CAP (default 256)."""
    filter_model = S.filter_model
    states0, obs0, ctrl0 = _get_eval_batch()
    t, n = states0.shape[:2]
    state_dim = filter_model.state_dim
    cap = int(os.environ.get("MMF_TPU_EVAL_BATCH_REPEATS_CAP", "256"))
    rc = max(1, min(repeats, max(1, cap // n)))
    while repeats % rc:  # equal-size chunks: one (T, N*rc) configuration
        rc -= 1
    chunks = repeats // rc
    print(
        f"[eval] batched repeats: {repeats} = {chunks} rollout(s) x {rc} "
        f"repeats (batch {n} -> {n * rc})"
    )
    filter_model.eval()

    raw_rmse_rows: List[np.ndarray] = []
    e2e_steps, e2e_time = 0, 0.0
    for _ in range(chunks):
        states, observations, controls = _get_eval_batch(tile=rc)
        nb = n * rc
        initialize_beliefs_for_eval(states, observations, measurement_initialize)
        obs_rest = {k: v[1:] for k, v in observations.items()}
        _warm_up_loop(filter_model, obs_rest, controls[1:], batch=nb)
        start = time.perf_counter()
        predicted = filter_model.forward_loop(
            observations=obs_rest, controls=controls[1:]
        ).cpu().numpy()
        e2e_time += time.perf_counter() - start
        e2e_steps += (t - 1) * nb
        if predicted.shape != (t - 1, nb, state_dim):
            raise ValueError(f"estimates of shape {predicted.shape}")
        true_states = states[1:]
        trunc = _burn_in_truncation(t)
        per_batch_mse = np.mean((predicted[trunc:] - true_states[trunc:]) ** 2, axis=0)
        # Repeat-major tiling: row r*N + i is repeat r of trajectory i.
        per_repeat_mse = per_batch_mse.reshape(rc, n, state_dim).mean(axis=1)
        raw_rmse_rows.extend(np.sqrt(per_repeat_mse))

    e2e_sps = float(e2e_steps / e2e_time) if e2e_time > 0 else 0.0
    device_sps = e2e_sps
    if os.environ.get("MMF_TPU_EVAL_DEVICE_THROUGHPUT", "1") == "1":
        # The stored belief is the tiled (N*rc) one; the chained timer runs
        # at the original batch, so re-initialize first.
        initialize_beliefs_for_eval(states0, obs0, measurement_initialize)
        device_sps = _device_throughput(obs0, ctrl0, states0)

    all_results: Dict[str, List[float]] = {}
    for raw_rmse in raw_rmse_rows:
        results = _metric_results(raw_rmse, device_sps, e2e_sps, verbose=False)
        results.pop("raw_rmse")
        for k, v in results.items():
            all_results.setdefault(k, []).append(v)
    return all_results


def run_eval(measurement_initialize=False, eval_dynamics=False) -> Dict[str, float]:
    """Evaluate the configured filter; print and return metrics.
    `eval_dynamics` runs the noise-free dynamics rollout instead of the
    filter."""
    filter_model = S.filter_model
    states, observations, controls = _get_eval_batch()
    t, n = states.shape[:2]
    state_dim = filter_model.state_dim

    filter_model.eval()

    init_mode = initialize_beliefs_for_eval(states, observations, measurement_initialize)
    print(f"init with {init_mode}"
          if init_mode == "random" else "initialize with measurement")

    # The timed region ends with the estimates on the host (.cpu(), which
    # also waits for the card); a first run of a configuration is excluded.
    if eval_dynamics:
        dynamics = filter_model.definition.dynamics_model
        initial = torch.from_numpy(np.ascontiguousarray(states[0])).to(filter_model.device)

        def rollout():
            with torch.no_grad():
                return dynamics.forward_loop(initial, controls[1:])[0].cpu().numpy()

        rollout()
        start = time.perf_counter()
        predicted_states = rollout()
        elapsed = time.perf_counter() - start
    else:
        obs_rest = {k: v[1:] for k, v in observations.items()}
        _warm_up_loop(filter_model, obs_rest, controls[1:], batch=n)
        start = time.perf_counter()
        predicted_states = filter_model.forward_loop(
            observations=obs_rest, controls=controls[1:]
        ).cpu().numpy()
        elapsed = time.perf_counter() - start

    if predicted_states.shape != (t - 1, n, state_dim):
        raise ValueError(f"estimates of shape {predicted_states.shape}")
    filter_steps_per_sec_e2e = float((t - 1) * n / elapsed)
    filter_steps_per_sec = filter_steps_per_sec_e2e
    if not eval_dynamics and os.environ.get("MMF_TPU_EVAL_DEVICE_THROUGHPUT", "1") == "1":
        filter_steps_per_sec = _device_throughput(observations, controls, states)

    true_states = states[1:]
    start_truncation = _burn_in_truncation(t)
    per_batch_mse = np.mean(
        (predicted_states[start_truncation:] - true_states[start_truncation:]) ** 2,
        axis=0,
    )
    raw_rmse = np.sqrt(np.mean(per_batch_mse, axis=0))
    return _metric_results(raw_rmse, filter_steps_per_sec, filter_steps_per_sec_e2e)
