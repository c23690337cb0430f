"""``correct`` comes out false when the timed path is broken underneath: a
whole run (the harness's look for a card skipped, here on the CPU at small
sizes) with each fault a cell can have planted in the program. Its cells
run on one card, so no exchange between cards can be left out. On a card,
at the cells' own sizes, the control (the reference in TF32 in the
program's place) fails too."""

from __future__ import annotations

import time

import pytest
import torch

from multimodalfilter_tpu_torch.filtering import pf as pf_module
from multimodalfilter_tpu_torch.ops import fused_step
from multimodalfilter_tpu_torch.train import loops
from multimodalfilter_tpu_torch.types import ParticleBelief
from portbench import calibrate, harness

EVAL_CELLS = ["door_pf.fused_n16", "push_pf.stepwise_n256"]
TRAIN_CELL = "door_pf.train_b32"


def _run(root, cell):
    return harness.run_cell(root, cell, 2**31 + 77, 0.2, False, torch.device("cpu"),
                            time.perf_counter())


def state_unchanged_eval(monkeypatch):
    """Every step hands back the belief it was given (per-step route and
    the fused route's plain version of B3)."""
    core = pf_module.ParticleFilterDef._step_core

    def step_core(self, belief, *args, **kwargs):
        return belief, core(self, belief, *args, **kwargs)[1]

    plain = fused_step.fused_forward_reference

    def fused(ops, belief, uniforms, record=None):
        return belief, torch.cat([plain(ops.step(t), belief, uniforms[t:t + 1])[1]
                                  for t in range(uniforms.shape[0])])

    monkeypatch.setattr(pf_module.ParticleFilterDef, "_step_core", step_core)
    monkeypatch.setattr(fused_step, "fused_forward_reference", fused)


def half_batch_eval(monkeypatch):
    """Half of the trajectories filtered; the rest get the mean of those."""
    loop = pf_module.ParticleFilterDef.forward_loop

    def forward_loop(self, belief, obs, controls, *, eps_seq, uniforms_seq, **kwargs):
        t, n = controls.shape[:2]
        h, (m, d) = n // 2, belief.particles.shape[1:]
        out, est = loop(self, ParticleBelief(belief.particles[:h], belief.log_weights[:h]),
                        {k: v[:, :h] for k, v in obs.items()}, controls[:, :h],
                        eps_seq=eps_seq.reshape(t, n, m, d)[:, :h].reshape(t, h * m, d),
                        uniforms_seq=uniforms_seq[:, :h], **kwargs)
        return out, torch.cat([est, est.mean(dim=1, keepdim=True).expand(t, n - h, d)], dim=1)

    monkeypatch.setattr(pf_module.ParticleFilterDef, "forward_loop", forward_loop)


def answer_altered_eval(monkeypatch):
    """The first step's estimate of the first trajectory moved by 1% of the
    scale."""
    loop = pf_module.ParticleFilterDef.forward_loop

    def forward_loop(self, *args, **kwargs):
        out, est = loop(self, *args, **kwargs)
        est = est.clone()
        est[0, 0, 0] += 0.01 * max(1.0, float(est.abs().max()))
        return out, est

    monkeypatch.setattr(pf_module.ParticleFilterDef, "forward_loop", forward_loop)


def late_one_slot_eval(monkeypatch):
    """The last trajectory's estimates moved by 1% of the scale from the
    middle step on (a fault in one slot that starts late)."""
    loop = pf_module.ParticleFilterDef.forward_loop

    def forward_loop(self, *args, **kwargs):
        out, est = loop(self, *args, **kwargs)
        est = est.clone()
        est[est.shape[0] // 2:, -1, 0] += 0.01 * max(1.0, float(est.abs().max()))
        return out, est

    monkeypatch.setattr(pf_module.ParticleFilterDef, "forward_loop", forward_loop)


def state_unchanged_train(monkeypatch):
    """Adam steps, and the parameters are put back as they were."""
    apply = loops.apply_gradients

    def apply_gradients(optimizer, module, frozen, reduce=None):
        before = [p.detach().clone() for p in module.parameters()]
        out = apply(optimizer, module, frozen, reduce)
        with torch.no_grad():
            for p, b in zip(module.parameters(), before):
                p.copy_(b)
        return out

    monkeypatch.setattr(loops, "apply_gradients", apply_gradients)


def half_batch_train(monkeypatch):
    """The loss is the mean over the first half of the batch."""
    loss = loops.e2e_loss

    def e2e_loss(defn, batch, **kwargs):
        h = batch["states"].shape[0] // 2
        half = {k: ({kk: vv[:h] for kk, vv in v.items()} if isinstance(v, dict) else v[:h])
                for k, v in batch.items()}
        return loss(defn, half, **kwargs)

    monkeypatch.setattr(loops, "e2e_loss", e2e_loss)


def answer_altered_train(monkeypatch):
    """The loss comes out 0.1% off."""
    loss = loops.e2e_loss
    monkeypatch.setattr(loops, "e2e_loss", lambda *a, **k: loss(*a, **k) * 1.001)


def window_batches_train(monkeypatch):
    """From the second epoch on (the window's, after set-up's first), every
    step of an epoch trains on the epoch's first batch."""
    run_epochs, calls = loops._run_epochs, []

    def _run_epochs(buddy, root, step, *args, **kwargs):
        calls.append(1)
        if len(calls) == 1:
            return run_epochs(buddy, root, step, *args, **kwargs)
        first = []

        def stale_step(batch):
            first.append(batch)
            return step(first[0])

        return run_epochs(buddy, root, stale_step, *args, **kwargs)

    monkeypatch.setattr(loops, "_run_epochs", _run_epochs)


@pytest.mark.parametrize("cell", EVAL_CELLS + [TRAIN_CELL])
def test_a_sound_run_is_correct(small_root, cell):
    assert _run(small_root, cell)["correct"] is True


@pytest.mark.parametrize("cell", EVAL_CELLS)
@pytest.mark.parametrize("fault", [state_unchanged_eval, half_batch_eval, answer_altered_eval,
                                   late_one_slot_eval])
def test_eval_faults_are_not_correct(small_root, monkeypatch, cell, fault):
    fault(monkeypatch)
    result = _run(small_root, cell)
    assert result["correct"] is False, result["checks"]


@pytest.mark.parametrize("fault", [state_unchanged_train, half_batch_train, answer_altered_train,
                                   window_batches_train])
def test_train_faults_are_not_correct(small_root, monkeypatch, fault):
    fault(monkeypatch)
    result = _run(small_root, TRAIN_CELL)
    assert result["correct"] is False, result["checks"]


@pytest.mark.gpu
@pytest.mark.parametrize("cell", EVAL_CELLS + ["door_pf.stepwise_n256", TRAIN_CELL])
def test_the_control_is_not_correct(card, full_root, cell):
    """At the cell's own sizes on the card, judged by the driver's own
    comparison against the cell's limits: the program is correct and the
    reference in TF32 in its place is not."""
    resolved = harness.resolve(full_root, cell)
    driver = harness.load_file_module(resolved.driver_path, "portbench_test_control_driver")
    run = harness.Run(resolved, 2**31 + 91, card)
    calibrate_cell = calibrate.calibrate_train if cell == TRAIN_CELL else calibrate.calibrate_eval
    out = calibrate_cell(driver, run, 0.2, control=True)
    assert out["program"]["correct"] is True, out["program"]
    assert out["control_tf32"]["correct"] is False, out["control_tf32"]
