"""The plain reference against the program's CPU path at small sizes, for
both configurations: the eval loop (per-step and fused routes) with the
draws made beforehand, and end-to-end training's first steps (losses, the
first gradient and the change after three Adam steps, leaf by leaf)."""

from __future__ import annotations

import json
import types

import numpy as np
import pytest
import torch

from portbench import harness, inputs, program
from portbench.reference import filters, nets

from .conftest import ROOT

CONFIGS = ["door_crossmodal_pf", "push_crossmodal_pf"]


def _config(name):
    return json.loads((ROOT / "portbench" / "configs" / f"{name}.json").read_text())


@pytest.mark.parametrize("config", CONFIGS)
def test_param_spec_is_the_programs_layout(config):
    cfg = _config(config)
    run = types.SimpleNamespace(config=cfg, seed=5, device=torch.device("cpu"),
                                traffic={"driver": "eval_loop", "M": 300})
    model, weights = program.build_model(run)  # loads with strict=True
    assert [k for k, _ in nets.param_spec(cfg)] == list(model.params.state_dict())
    assert all(torch.equal(weights[k], v) for k, v in model.params.state_dict().items())


@pytest.mark.parametrize("config", CONFIGS)
@pytest.mark.parametrize("fused", [False, True])
def test_eval_loop_matches_the_program(config, fused):
    cfg = _config(config)
    traffic = {"driver": "eval_loop", "T": 8, "N": 3, "M": 48, "initial_cov_scale": 0.1,
               "knobs": {"MMF_TPU_FUSED_STEP": "1"} if fused else {}}
    run = types.SimpleNamespace(config=cfg, traffic=traffic, seed=11, device=torch.device("cpu"))
    model, weights = program.build_model(run)
    model.eval()
    assert model.definition.fused_step == fused
    x = inputs.eval_request_inputs(cfg, traffic, run.seed, 0, run.device)
    model.generator.manual_seed(1234)
    model.initialize_beliefs(mean=x["mean"], covariance=x["cov"])
    got = model.forward_loop(observations=x["obs"], controls=x["controls"],
                             eps_seq=x["eps_seq"], uniforms_seq=x["uniforms"])
    eps0 = torch.randn((3, 48, cfg["state_dim"]), generator=torch.Generator().manual_seed(1234))
    with torch.no_grad():
        ref, drawn = filters.eval_loop(weights, cfg, x["obs"], x["controls"], x["mean"], x["cov"],
                                       eps0, x["eps_seq"], x["uniforms"])
    assert got.shape == ref.shape == (8, 3, cfg["state_dim"])
    assert torch.equal(drawn, x["uniforms"])
    torch.testing.assert_close(got, ref, rtol=0, atol=1e-5 * max(1.0, float(ref.abs().max())))


def test_draws_near_a_cdf_entry_are_made_again():
    """With a margin, the reference's loop draws again every uniform that
    lies that close to an entry of its step's CDF, and only those."""
    cfg = _config("door_crossmodal_pf")
    traffic = {"T": 6, "N": 3, "M": 40, "initial_cov_scale": 0.1}
    x = inputs.eval_request_inputs(cfg, traffic, 3, 0, torch.device("cpu"))
    w = inputs.make_weights(cfg, 3, torch.device("cpu"))
    eps0 = torch.randn((3, 40, 3), generator=torch.Generator().manual_seed(9))
    args = (w, cfg, x["obs"], x["controls"], x["mean"], x["cov"], eps0, x["eps_seq"])
    with torch.no_grad():
        _, drawn = filters.eval_loop(*args, x["uniforms"], margin=0.003,
                                     redraw=torch.Generator().manual_seed(4))
        again, same = filters.eval_loop(*args, drawn)  # the drawn ones need no redraw
        _, kept = filters.eval_loop(*args, drawn, margin=0.003, redraw=torch.Generator())
    changed = drawn != x["uniforms"]
    assert 0 < int(changed.sum()) < changed.numel() // 2
    assert torch.equal(same, drawn) and torch.equal(kept, drawn)


def test_train_epochs_match_the_program(small_root):
    """The first three steps of the program's first epoch and of the
    window's last, leaf by leaf (every leaf, not only the median one the
    chip compares)."""
    cell = harness.resolve(small_root, "door_pf.train_b32")
    driver = harness.load_file_module(cell.driver_path, "portbench_test_train_driver")
    state = driver.setup(harness.Run(cell, 21, torch.device("cpu")))
    driver.window(state, 0.0)  # one epoch
    got = driver.program_readings(state)
    driver.release(state)
    ref = driver.reference_readings(state)
    np.testing.assert_allclose(got.first_losses, ref.first_losses, rtol=1e-5)
    assert len(got.first_losses) == 3
    assert len(got.last_grads) == len(ref.last_grads) == 3
    for gots, refs, tol in ((got.first_grads, ref.first_grads, 1e-4),
                            (got.first_updates, ref.first_updates, 1e-3),
                            *((a, b, 1e-4) for a, b in zip(got.last_grads, ref.last_grads))):
        assert set(gots) == set(refs)
        assert all(v > 0 for v in refs.values())
        assert max(driver.leaf_gaps(gots, refs, refs).values()) <= tol
