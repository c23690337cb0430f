"""A pipelined serving bundle in a world of two CPU ranks (gloo): the port's
counterpart of the JAX package's pipelined export (its
``experiments/export.py:138-180, 255-280``). The door crossmodal PF at full
width, JAX's seeded weights, N = 4, T = 8, M = 16.

The bundle holds one stage's program over a T/P chunk of one microbatch;
loaded on both ranks it runs the pipeline's schedule around it, and its
loop replays the live pipelined model's from the same seed."""

import sys

import numpy as np
import pytest
import torch

from crossmodal import door_models as jdoor
from multimodalfilter_tpu_torch.parallel.launch import spawn

sys.path.insert(0, "tests")
import test_torch_port_dist_worker as worker  # noqa: E402
import test_torch_port_multidevice as four  # noqa: E402


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    jm = jdoor.DoorCrossmodalParticleFilter()
    obs, controls = worker.sequences(four.T, four.N, seed=3)
    r = np.random.default_rng(4)
    inputs = {"params": four._numpy_state(jm.params), "obs": obs, "controls": controls,
              "mean": (0.3 * r.normal(size=(four.N, 3))).astype(np.float32),
              "cov": np.tile(np.eye(3, dtype=np.float32) * 0.1, (four.N, 1, 1)),
              "m": four.M, "work": str(tmp_path_factory.mktemp("pipelined_bundles"))}
    return spawn(worker.export_rank_cases, 2, "cpu", inputs, timeout_s=240)


def test_pipelined_bundle_replays_the_live_pipeline(world):
    """A 2-stage pipeline: the bundle records the axes, shape, stages and
    microbatches; its estimates and final belief are the live pipelined
    model's bit for bit (the same ATen operations on the same draws), on
    both ranks."""
    name = "pipe"
    for rank in world:
        case = rank[name]
        assert case["meta"]["stages"] == 2 and case["meta"]["microbatches"] == 2
        assert case["meta"]["axes"] == ["pipe"] and case["meta"]["shape"] == [2]
        assert case["served"].shape == (four.T, four.N, 3)
        torch.testing.assert_close(case["served"], case["live"], rtol=0, atol=0)
        torch.testing.assert_close(*case["belief"], rtol=0, atol=0)
    torch.testing.assert_close(world[1][name]["served"], world[0][name]["served"], rtol=0,
                               atol=0)
