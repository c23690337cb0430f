"""The port's push CLIs (``scripts/push_task/{train_push,eval_push}.py``) and
push metrics on the CPU: the metric dict against the JAX package's, and the
two CLIs end to end on tiny synthetic push sets, with ``--resume`` on the
finished run. (The curricula of ``train_push.run_curriculum`` are held
against the JAX package's in ``tests/test_torch_port_push_models.py``,
beside the JAX models they share.)
"""

import json
import sys
import numpy as np
import pytest
import torch

import crossmodal._eval_metrics as jmetrics
import crossmodal._eval_state as jstate
from crossmodal.tasks import PushTask as JaxPushTask
from multimodalfilter_tpu_torch.crossmodal import _eval_metrics as tmetrics
from multimodalfilter_tpu_torch.crossmodal import _eval_state as tstate
from multimodalfilter_tpu_torch.crossmodal import train_helpers
from multimodalfilter_tpu_torch.crossmodal.tasks import PushTask
from multimodalfilter_tpu_torch.data import cache
from multimodalfilter_tpu_torch.scripts.push_task import eval_push, train_push
from multimodalfilter_tpu_torch.train import loops as tloops
from test_torch_port_train_cli import METADATA_KEYS


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread while this module runs (the suite runs in several
    worker processes at once). Restored after the module."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("kloss", [False, True], ids=["mujoco", "kloss"])
def test_push_metric_dict_matches_jax(monkeypatch, kloss):
    """The same raw RMSE gives the JAX package's metric dict, for a MuJoCo
    and a kloss eval alike (both de-normalise with the MuJoCo stddevs)."""
    monkeypatch.setattr(jstate, "task", JaxPushTask)
    monkeypatch.setattr(tstate, "task", PushTask)
    monkeypatch.setattr(jstate, "dataset_args", {"kloss_dataset": kloss})
    monkeypatch.setattr(tstate, "dataset_args", {"kloss_dataset": kloss})
    raw = np.random.default_rng(3 + kloss).uniform(size=2)
    want = jmetrics.metric_results(raw, 10.0, 20.0, verbose=False)
    assert tmetrics.metric_results(raw, 10.0, 20.0, verbose=False) == want
    assert want["x_rmse_cm"] == float(raw[0] * 0.0572766 * 100.0)


@pytest.fixture()
def cli_workspace(tmp_path, monkeypatch):
    """A working directory (Buddy's directories), an empty dataset cache, tiny
    synthetic push sets (two trajectories of 18-21 steps a file) and every
    curriculum call cut to one optimizer step (one epoch of one batch, of at
    most the dataset's size), so that the curricula run on them in seconds;
    sys's excepthook restored after (the CLI installs pdb_safety_net's)."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(sys, "excepthook", sys.excepthook)
    monkeypatch.setattr(cache, "_cache_path", None)  # the CLI sets it
    monkeypatch.setattr(cache, "_in_memory", {})
    for key, value in (("MMF_TPU_SYNTHESIZE_DATA", "1"), ("MMF_TPU_SYNTH_T", "18"),
                       ("MMF_TPU_SYNTH_TRAJ", "2"), ("MMF_TPU_OFFLINE", "1"),
                       ("MMF_TPU_EVAL_DEVICE_THROUGHPUT", "0")):
        monkeypatch.setenv(key, value)
    monkeypatch.delenv("MMF_TPU_SERVING", raising=False)
    calls = []
    for name in ("train_e2e", "train_pf_dynamics_single_step", "train_pf_dynamics_recurrent",
                 "train_pf_measurement", "train_virtual_sensor"):
        real = getattr(train_helpers, name)

        def cut(*args, real=real, name=name, **kwargs):
            calls.append(name)
            return real(*args, **{**kwargs, "epochs": 1})

        monkeypatch.setattr(train_helpers, name, cut)
    batches = tloops._epoch_index_matrix
    monkeypatch.setattr(tloops, "_epoch_index_matrix",
                        lambda rng, n, batch_size: batches(rng, n, min(n, batch_size))[:1])
    return tmp_path, calls


@pytest.mark.parametrize("model_type,last", [("PushCrossmodalParticleFilter", "phase4"),
                                             ("PushKalmanFilter", "phase3")])
def test_train_then_eval_cli_end_to_end(cli_workspace, model_type, last, capsys):
    """train_push.main trains the class through its curriculum on the CPU
    and evaluates it; eval_push.main rebuilds it from the metadata and the
    last checkpoint and runs run_eval_stats; --resume on the finished run
    trains nothing and evaluates the same weights."""
    work, calls = cli_workspace
    cache_dir = str(work / "cache")
    argv = ["--model-type", model_type, "--experiment-name", "push", "--device", "cpu"]
    results = train_push.main(argv, cache_dir=cache_dir)
    assert calls and (work / "checkpoints" / "push" / f"{last}.pt").exists()
    meta = json.loads((work / "metadata" / "push.json").read_text())
    assert set(meta) == METADATA_KEYS and meta["model_type"] == model_type
    assert meta["dataset_args"]["kloss_dataset"] is False
    assert results.keys() >= {"x_rmse_cm", "y_rmse_cm"} and "theta_rmse_deg" not in results
    assert np.isfinite(results["raw_rmse"]).all() and len(results["raw_rmse"]) == 2

    stats = eval_push.main(["--experiment-name", "push", "--device", "cpu", "--save"],
                           cache_dir=cache_dir)
    assert {"x_rmse_cm_mean", "y_rmse_cm_mean", "x_rmse_cm_std"} <= stats.keys()
    assert np.isfinite(stats["x_rmse_cm_mean"]) and np.isfinite(stats["y_rmse_cm_mean"])
    meta = json.loads((work / "metadata" / "push.json").read_text())
    assert meta["eval_results_stats"]["x_rmse_cm_mean"] == stats["x_rmse_cm_mean"]

    trained = torch.load(work / "checkpoints" / "push" / f"{last}.pt", weights_only=True)
    n_calls = len(calls)
    resumed = train_push.main(argv + ["--resume"], cache_dir=cache_dir)
    assert len(calls) == n_calls  # every phase's checkpoint exists: nothing trains
    again = torch.load(work / "checkpoints" / "push" / f"{last}.pt", weights_only=True)
    assert all(torch.equal(v, again["params"][k]) for k, v in trained["params"].items())
    assert resumed.keys() == results.keys()
    capsys.readouterr()
