"""Curriculum resume, ``--resume`` on the train CLI (port of
``crossmodal/resume.py``).

An unchanged ``run_curriculum`` resumes from its latest completed phase
checkpoint. It runs in **two passes**, with the ``(buddy, train_helpers,
eval_helpers)`` triple wrapped in proxies:

1. **Probe.** Every expensive call (``train_helpers.train_*``,
   ``eval_helpers.log_eval``, ``buddy.load_checkpoint_module``) is a no-op,
   and ``buddy.save_checkpoint(label)`` checks whether that checkpoint
   exists. The *frontier* is the last label of the unbroken chain of
   existing checkpoints from the start; the probe stops at the first
   missing one. If it runs to the end, every phase is done: the frontier
   is restored (so the CLI's final eval sees the trained weights) and
   nothing runs again.
2. **Fast-forward.** ``run_curriculum`` runs again from the top, its
   expensive calls no-ops until ``save_checkpoint(frontier)``. There the
   frontier checkpoint is restored (parameters, the step count and the
   optimizer states, ``Buddy.load_checkpoint``) and every call runs live
   from then on.

Why two passes: the curricula change the model between their train calls
(``freeze_module``, ``enabled_models = [...]``,
``buddy._optimizer_dict.clear()``). Running the curriculum again from the top
applies each change in order (each is an assignment, so applying it again
changes nothing), and the restore happens at the frontier's own place in
that order. So a clear after the frontier drops the restored optimizer
states as an uninterrupted run would, and each live train call sees the
freeze and enabled state it would have seen.

A skipped ``load_checkpoint_module`` still raises what ``Buddy`` would raise
(``FileNotFoundError``) when its source checkpoint is missing: the
crossmodal-PF curriculum's warm-start falls back on it, so the branch it
takes is the same in every pass.

Phase labels should be unique within a curriculum: a repeated or ``None``
label ends the skippable prefix there, and everything after it runs live.
Calls after the final save run live again on resume.
"""

from __future__ import annotations

import os
from typing import Optional

from ..experiments.buddy import CHECKPOINT_SUFFIX


def _labeled_checkpoint_exists(buddy, label, experiment_name=None) -> bool:
    """``Buddy._read_checkpoint``'s lookup, without reading."""
    if label is not None:
        return os.path.exists(buddy._checkpoint_path(label, experiment_name))
    exp_dir = os.path.join(buddy._checkpoint_dir, experiment_name or buddy.experiment_name)
    return os.path.isdir(exp_dir) and any(
        p.endswith(CHECKPOINT_SUFFIX) for p in os.listdir(exp_dir))


class _Restart(Exception):
    """Ends the probe pass at the first incomplete phase."""


class _GatingProxy:
    """Passes every attribute through to `real`, except the callables named
    in `gated`: outside live mode those are no-ops (the fast-forward pass
    runs them live past the restore)."""

    def __init__(self, controller: "ResumableCurriculum", real, gated):
        self._rc = controller
        self._real = real
        self._gated = frozenset(gated)

    def __getattr__(self, name: str):
        attr = getattr(self._real, name)
        if name in self._gated and callable(attr) and self._rc._mode != "live":

            def gate(*args, **kwargs):
                if self._rc._mode == "live":  # went live since the lookup
                    return attr(*args, **kwargs)
                self._rc._trailing = True
                self._rc._skipped += 1
                return None

            return gate
        return attr


class _BuddyProxy(_GatingProxy):
    def __init__(self, controller, buddy):
        super().__init__(controller, buddy, gated=())

    def save_checkpoint(self, label: Optional[str] = None):
        rc = self._rc
        real = self._real
        if rc._mode == "live":
            return real.save_checkpoint(label)
        if rc._mode == "probe":
            # A None or repeated label cannot key a resume point: the
            # skippable prefix ends here.
            if label is None or label in rc._seen or not _labeled_checkpoint_exists(real, label):
                raise _Restart
            rc._seen.add(label)
            rc._frontier = label
            rc._trailing = False
            n, rc._skipped = rc._skipped, 0
            print(f"[resume] phase '{label}' already complete — skipped "
                  f"({n} call{'s' if n != 1 else ''})")
            return real._checkpoint_path(label)
        if label == rc._target:
            print(f"[resume] restoring '{label}' and resuming live")
            real.load_checkpoint(label=label)
            rc._mode = "live"
        return real._checkpoint_path(label)

    def load_checkpoint_module(self, source, target=None, label=None, experiment_name=None):
        rc = self._rc
        if rc._mode == "live":
            return self._real.load_checkpoint_module(
                source, target=target, label=label, experiment_name=experiment_name)
        # Raise now if the source checkpoint is missing, as Buddy would (the
        # warm-start fallback catches it); skip only the load.
        if not _labeled_checkpoint_exists(self._real, label, experiment_name):
            path = self._real._checkpoint_path(label, experiment_name)
            if label is not None:
                raise FileNotFoundError(f"No checkpoint {path}")
            raise FileNotFoundError(f"No checkpoints found in {os.path.dirname(path)}")
        rc._trailing = True
        rc._skipped += 1
        return None


_TRAIN_GATED = (
    "train_e2e",
    "train_pf_dynamics_single_step",
    "train_pf_dynamics_recurrent",
    "train_pf_measurement",
    "train_virtual_sensor",
)
_EVAL_GATED = ("log_eval",)


class ResumableCurriculum:
    """Wraps (buddy, train_helpers, eval_helpers) so that an unchanged
    ``run_curriculum`` resumes from its latest completed phase checkpoint::

        rc = ResumableCurriculum(buddy, train_helpers, eval_helpers,
                                 enabled=args.resume)
        rc.run(run_curriculum, filter_model)

    ``run`` calls ``run_curriculum(*args, buddy, train_helpers,
    eval_helpers)`` with the proxied triple: once when nothing or everything
    is done, twice (probe, then fast-forward) when resuming mid-curriculum.
    The probe trains nothing."""

    def __init__(self, buddy, train_helpers, eval_helpers, enabled: bool = True):
        self._real_buddy = buddy
        self._enabled = bool(enabled)
        self._mode = "probe" if enabled else "live"
        self._frontier: Optional[str] = None
        self._target: Optional[str] = None
        self._seen: set = set()
        self._trailing = False  # gated calls after the last completed save
        self._skipped = 0
        self.buddy = _BuddyProxy(self, buddy) if enabled else buddy
        self.train_helpers = (_GatingProxy(self, train_helpers, _TRAIN_GATED)
                              if enabled else train_helpers)
        self.eval_helpers = (_GatingProxy(self, eval_helpers, _EVAL_GATED)
                             if enabled else eval_helpers)

    def run(self, run_curriculum, *args) -> None:
        triple = (self.buddy, self.train_helpers, self.eval_helpers)
        if not self._enabled:
            run_curriculum(*args, *triple)
            return
        # Pass 1 (probe): find the frontier without training.
        self._mode = "probe"
        try:
            run_curriculum(*args, *triple)
            if not self._trailing:
                # Every phase is done: restore the last checkpoint so that the
                # caller's final eval sees the trained weights.
                if self._frontier is not None:
                    print(f"[resume] curriculum complete; restoring '{self._frontier}'")
                    self._real_buddy.load_checkpoint(label=self._frontier)
                else:
                    print("[resume] curriculum has no phase checkpoints")
                self._mode = "live"
                return
            # Gated calls after the final save: fast-forward and run them.
        except _Restart:
            pass
        # Pass 2 (fast-forward): from the top, restore at the frontier's
        # place, then live.
        self._target = self._frontier
        self._seen = set()
        self._skipped = 0
        if self._target is None:
            print("[resume] nothing completed yet; training from scratch")
            self._mode = "live"
        else:
            print(f"[resume] fast-forwarding to '{self._target}'")
            self._mode = "fastforward"
        run_curriculum(*args, *triple)
