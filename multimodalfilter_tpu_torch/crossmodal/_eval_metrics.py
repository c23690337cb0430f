"""Eval metric math, the reference's RMSE pipeline (port of
``crossmodal/_eval_metrics.py``).

RMSE with the first 30 steps truncated, de-normalized with the dataset's
hardcoded stddevs, converted to degrees and cm, with the same metric names.
These constants are the metric system; they are copied verbatim.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from . import _eval_state as S
from .tasks import DoorTask


def burn_in_truncation(t: int) -> int:
    """Steps excluded from RMSE at the front of a T-step rollout.

    The reference's truncation: the first 30 steps are filter burn-in.
    Real eval trajectories are hundreds of steps; synthetic smoke evals can
    be shorter than 31, which would leave an EMPTY metric
    slice (RMSE = NaN from a mean over zero elements) — fall back to
    truncating the first half so short-T smoke runs stay meaningful.
    Real-length evals are unaffected. Single source of truth for both the
    sequential and the batched-repeats eval paths."""
    return 30 if (t - 1) > 30 else (t - 1) // 2


def metric_results(
    raw_rmse, filter_steps_per_sec, filter_steps_per_sec_e2e, verbose=True
) -> Dict[str, float]:
    """Task-specific de-normalized metric dict from a (state_dim,) raw RMSE;
    shared by run_eval and the batched-repeats path."""
    if S.task is DoorTask:
        rmse = raw_rmse * np.array([0.39479038, 0.05650279, 0.0565098])
        results = {
            "raw_rmse": [float(x) for x in raw_rmse],
            "theta_rmse_deg": float(rmse[0] * 180.0 / np.pi),
            "x_rmse_cm": float(rmse[1] * 100.0),
            "y_rmse_cm": float(rmse[2] * 100.0),
            "filter_steps_per_sec": filter_steps_per_sec,
            "filter_steps_per_sec_e2e": filter_steps_per_sec_e2e,
        }
        if verbose:
            print()
            print("-----")
            print(f"Raw RMSE:   {results['raw_rmse']}")
            print("-----")
            print(f"Theta RMSE: {results['theta_rmse_deg']:.8f} degrees")
            print(f"X RMSE:     {results['x_rmse_cm']:.8f} cm")
            print(f"Y RMSE:     {results['y_rmse_cm']:.8f} cm")
            print(
                f"Throughput: {filter_steps_per_sec:.1f} filter-steps/sec "
                f"(device), {filter_steps_per_sec_e2e:.1f} e2e incl. host fetch"
            )
            print("-----")
    else:
        raise NotImplementedError(
            f"eval metrics of {getattr(S.task, '__name__', S.task)}: only DoorTask "
            "is ported (the push task comes with ROADMAP A11)"
        )

    return results
