"""``portbench/counts`` against ``torch.utils.flop_counter.FlopCounterMode``
run over the plain reference, and against the bound values that
``chip_smoke.py`` printed for B1, B2 and B3."""

from __future__ import annotations

import json

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import counts, inputs
from portbench.reference import filters

from .conftest import ROOT


def _config(name):
    return json.loads((ROOT / "portbench" / "configs" / f"{name}.json").read_text())


def _counted(fn) -> int:
    with FlopCounterMode(display=False) as counter:
        fn()
    return counter.get_total_flops()


@pytest.mark.parametrize("config", ["door_crossmodal_pf", "push_crossmodal_pf"])
def test_eval_request_against_flop_counter(config):
    cfg = _config(config)
    t, n, m, d = 3, 2, 5, cfg["state_dim"]
    traffic = {"T": t, "N": n, "M": m, "initial_cov_scale": 0.1}
    w = inputs.make_weights(cfg, 1, "cpu")
    x = inputs.eval_request_inputs(cfg, traffic, 1, 0, "cpu")
    eps0 = torch.randn((n, m, d))
    counted = _counted(lambda: filters.eval_loop(w, cfg, x["obs"], x["controls"], x["mean"],
                                                 x["cov"], eps0, x["eps_seq"], x["uniforms"]))
    # The counter also sees two contractions the counts file as elementwise
    # work: the initial belief's chol @ eps and each step's weighted mean.
    extra = 2 * n * m * d * d + t * 2 * n * m * d
    assert counted - extra == t * n * counts.frame_macs2(cfg) + t * n * m * counts.particle_step_macs2(cfg)
    assert counts.eval_request_flops(cfg, t, n, m) > counted - extra


def test_train_step_against_flop_counter():
    cfg = _config("door_crossmodal_pf")
    b, seq_len, m, d = 2, 3, 4, cfg["state_dim"]
    data = inputs.train_subsequences(cfg, {"subsequences": b, "L": seq_len, "state_step_std": 0.05},
                                     1, "cpu")
    w = {k: v.requires_grad_(True) for k, v in inputs.make_weights(cfg, 1, "cpu").items()}
    eps0, eps_seq = torch.randn((b, m, d)), torch.randn((seq_len - 1, b * m, d))

    def step():
        loss = filters.e2e_loss(w, cfg, data["states"], data["controls"], data["obs"], eps0,
                                eps_seq, 0.1)
        loss.backward()

    counted = _counted(step)
    frames = b * (seq_len - 1)
    forward = frames * counts.frame_macs2(cfg) + frames * m * counts.particle_step_macs2(cfg)
    # Backward: two products per forward product, one fewer where the input
    # needs no gradient (the images into the first convolutions, the
    # controls and observations into the first dense layers).
    assert 2.9 * forward < counted < 3.0 * forward + (seq_len - 1) * 6 * b * m * d
    assert counts.train_step_flops(cfg, b, seq_len, m) >= 3 * forward


def test_bounds_as_chip_smoke_printed_them():
    door = _config("door_crossmodal_pf")
    assert counts.tail_bytes(16, 300, 3) == 192_192
    assert counts.tail_bound_s(16, 300, 3) == pytest.approx(0.0574e-6, rel=2e-3)
    assert counts.b3_ops(door, 100, 16, 300) == pytest.approx(9.14e10, rel=1e-3)
    assert counts.b3_bound_s(door, 100, 16, 300) == pytest.approx(1.364e-3, rel=1e-3)
    push = _config("push_crossmodal_pf")
    assert counts.b3_ops(push, 100, 16, 300) == pytest.approx(9.11e10, rel=1e-3)
    assert counts.b2_bound_s(32, 30, 3, backward=False) == pytest.approx(0.00699e-6, rel=1e-3)
    assert counts.b2_bound_s(32, 30, 3, backward=True) == pytest.approx(0.01055e-6, rel=1e-3)
    # The image encoder: about 52 MFLOP a frame.
    assert counts.image_encoder_macs2(door) == pytest.approx(52.2e6, rel=1e-2)
