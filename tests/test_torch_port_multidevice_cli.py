"""The multi-device CLIs and the data-parallel eval in a world of two CPU
ranks (gloo), and the dry run: the port's counterpart of the JAX package's
tests/test_eval_sharded.py and of its CLIs' parallelism flags.

One world runs every case (``test_torch_port_dist_worker.two_rank_cases``)
on the door crossmodal PF at full width, the door sets synthesised in
memory (two trajectories of 16-19 steps a file). The data-parallel epoch
at W = 2 replays JAX's draws of that epoch, as the W = 4 case of
test_torch_port_multidevice.py does.
"""

import sys

import jax
import numpy as np
import pytest
import torch

from crossmodal import door_models as jdoor
from multimodalfilter_tpu.parallel.cli import add_parallelism_args as jax_add_parallelism_args
from multimodalfilter_tpu_torch.parallel.dryrun import dryrun_multichip
from multimodalfilter_tpu_torch.parallel.launch import spawn

sys.path.insert(0, "tests")
import test_torch_port_dist_worker as worker  # noqa: E402
import test_torch_port_multidevice as four  # noqa: E402

# The eval's RMSEs (degrees and cm) from estimates that differ by fp32 sum
# order (each rank filters its rows as a batch of its own): the RMSE moves
# by at most the largest per-step gap (triangle inequality), which the
# multi-device loops keep within 1e-5 of the estimates' scale.
RMSE_RTOL = 1e-4
STAT_KEYS = {f"{k}_{s}" for k in ("theta_rmse_deg", "x_rmse_cm", "y_rmse_cm",
                                   "filter_steps_per_sec", "filter_steps_per_sec_e2e")
             for s in ("mean", "std")}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("multidevice_cli")
    jm = jdoor.DoorCrossmodalParticleFilter()
    n_batches = four.DP["count"] * 2 // four.DP["batch"]
    inputs = {"cache": str(tmp / "cache"), "work": str(tmp / "work"),
              "params": four._numpy_state(jm.params),
              "dp": {**four.DP, "logs": str(tmp / "logs"),
                     "draws": four._epoch_noise(jm._rng, n_batches)}}
    return {"ranks": spawn(worker.two_rank_cases, 2, "cpu", inputs, timeout_s=240),
            "work": tmp / "work"}


@pytest.mark.parametrize("key", ["theta_rmse_deg", "x_rmse_cm", "y_rmse_cm"])
def test_data_parallel_eval_matches_one_device(world, key):
    """run_eval, and run_eval_stats with the repeats folded into the batch,
    over a 2-wide data axis: each rank filters its rows with the global
    draws, the estimates gathered in rank order, so the metrics are those of
    the same eval on one device, on every rank."""
    for rank in world["ranks"]:
        runs = rank["dp_eval"]
        np.testing.assert_allclose(runs["mesh"][key], runs["single"][key], rtol=RMSE_RTOL)
        for stat in ("mean", "std"):
            np.testing.assert_allclose(runs["mesh_stats"][f"{key}_{stat}"],
                                       runs["single_stats"][f"{key}_{stat}"], rtol=RMSE_RTOL)
    assert world["ranks"][1]["dp_eval"]["mesh"][key] == world["ranks"][0]["dp_eval"]["mesh"][key]


def test_configure_checks_the_mesh(world):
    """A data-parallel mesh without a 'data' axis, and both meshes at once,
    are refused."""
    errors = world["ranks"][0]["configure_errors"]
    assert "'data' axis" in errors["axis"]
    assert "exclusive" in errors["both"]


def test_train_cli_data_parallel_writes_on_rank_zero(world):
    """train_door --data-parallel 2 trains (two optimizer steps) on both
    ranks alike; rank 0 writes the checkpoint, the metadata and the logs,
    and the other rank, in a working directory of its own, writes nothing."""
    rank0, rank1 = world["ranks"]
    assert rank1["train_files"] == []
    assert "checkpoints/dp_cli/phase0.pt" in rank0["train_files"]
    assert "metadata/dp_cli.json" in rank0["train_files"]
    assert any(f.startswith("logs/dp_cli/") for f in rank0["train_files"])
    for k, v in rank0["params"].items():
        assert torch.equal(rank1["params"][k], v), k
    saved = torch.load(world["work"] / "rank0" / "checkpoints" / "dp_cli" / "phase0.pt",
                       weights_only=True)
    assert saved["steps"] == 2
    for key in ("theta_rmse_deg", "x_rmse_cm", "y_rmse_cm"):  # the rates are each rank's
        assert rank0["train"][key] == rank1["train"][key]


def test_eval_cli_pipelined_from_the_checkpoint(world):
    """eval_door --pipeline-stages 2 on the data-parallel run's checkpoint
    gives the JAX CLI's result keys (the one-device CLI's,
    test_torch_port_eval.py), finite and the same on both ranks."""
    rank0, rank1 = world["ranks"]
    assert rank0["eval_pipelined"].keys() == STAT_KEYS
    for key, value in rank0["eval_pipelined"].items():
        assert np.isfinite(value), key
        if "rmse" in key:  # the rates are each rank's
            assert rank1["eval_pipelined"][key] == value, key


def test_data_parallel_epoch_at_two_ranks(world):
    """train_e2e over a 2-wide data axis: the one-device epoch's step
    gradients and loss, the frozen gate unchanged, one gradient all-reduce
    per optimizer step."""
    dp = world["ranks"][0]["dp_train"]["mesh"]
    single = world["ranks"][0]["dp_train"]["single"]
    assert dp["counts"] == {("all_reduce_sum", "mesh"): 2, ("broadcast", "mesh"): 1}
    np.testing.assert_allclose(dp["loss"], single["loss"], rtol=four.LOSS_RTOL)
    for step_dp, step_single in zip(dp["grads"], single["grads"]):
        for k, g in step_single.items():
            four._scale_close(step_dp[k].numpy(), g.numpy(), four.GRAD_RTOL, k)
    for k, v in dp["params"].items():
        if k.startswith("measurement_model.crossmodal_weight_model."):
            assert torch.equal(v, world["ranks"][0]["dp_train"]["single"]["params"][k]), k


def test_parallelism_flags_are_the_jax_clis():
    """The port's flag group parses what the JAX CLI's does."""
    import argparse

    from multimodalfilter_tpu_torch.parallel.cli import add_parallelism_args

    argv = ["--data-parallel", "2", "--pipeline-stages", "4", "--pipeline-microbatches", "3",
            "--particle-shards", "2"]
    parsed = []
    for add in (add_parallelism_args, jax_add_parallelism_args):
        parser = argparse.ArgumentParser()
        add(parser)
        parsed.append(vars(parser.parse_args(argv)))
    assert parsed[0] == parsed[1]


def test_dryrun_multichip_prints_both_lines(capsys):
    """dryrun_multichip(2): one data-parallel step and the particle-sharded
    loop in a world of two ranks."""
    dryrun_multichip(2)
    out = capsys.readouterr().out
    assert "DP OK" in out and "particle-sharding OK" in out
