"""The port's door train CLI (``scripts/door_task/train_door.py``) against the
JAX package's on the CPU: the curricula of the ten door classes, and the
CLI's wiring (flags, metadata, the refused options).

The curricula run with every training primitive recorded instead of run and
a fake buddy, as ``tests/test_scripts.py`` runs the JAX package's: both
packages must make the same calls with the same arguments, save the same
labels, load the same modules and clear the optimizers at the same places,
each call under the same enabled modalities and frozen paths. The JAX
models are built with their init traced, not compiled (``eval_shape``):
the curricula never read a parameter.
"""

import json
import sys
from pathlib import Path

import jax
import pytest
import torch

from crossmodal.tasks import DoorTask as JaxDoorTask
from multimodalfilter_tpu.filtering import wrappers as jwrappers
from multimodalfilter_tpu_torch.crossmodal import door_models as tdoor
from multimodalfilter_tpu_torch.crossmodal import eval_helpers as teval
from multimodalfilter_tpu_torch.crossmodal.tasks import DoorTask
from multimodalfilter_tpu_torch.data import cache
from multimodalfilter_tpu_torch.scripts.door_task import train_door

REPO = Path(__file__).resolve().parents[1]
PORT_TYPES = sorted(DoorTask.model_types)
# The JAX CLI's metadata keys (scripts/door_task/train_door.py:75-85, :116-122).
METADATA_KEYS = {"model_type", "dataset_args", "train_start_time", "commit_hash",
                 "notes", "train_end_time", "eval_results"}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread while this module runs: the suite runs in several
    worker processes at once, and torch's default pool of one thread a core
    in each of them oversubscribes the machine (a 512x512 QR of the LSTM's
    init then takes ~0.5 s instead of ~10 ms). Restored after the module."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_train_door():
    sys.path.insert(0, str(REPO / "scripts" / "door_task"))
    import train_door as jax_train_door

    return jax_train_door


class _Clears(dict):
    def __init__(self, log):
        super().__init__()
        self.log = log

    def clear(self):
        self.log.append(("optimizers cleared",))
        super().clear()


class FakeBuddy:
    """Records saves and module loads; a load from another experiment
    raises FileNotFoundError, as in a fresh workspace."""

    def __init__(self, log):
        self.log = log
        self._optimizer_dict = _Clears(log)

    def save_checkpoint(self, label=None):
        self.log.append(("save", label))

    def load_checkpoint_module(self, source, target=None, label=None, experiment_name=None):
        if experiment_name is not None:
            raise FileNotFoundError(experiment_name)
        self.log.append(("load module", source, target, label))


def _handle_path(value):
    """A submodule handle (``model=filter_model.filter_models[0]``) by its
    dotted path, which both packages' handles carry; other values as they
    are."""
    if hasattr(value, "root") and hasattr(value, "path"):
        return ("handle", value.path)
    return value


class Recorder:
    """A helper module whose every function records its name and kwargs,
    with the model's enabled modalities and frozen paths at the call."""

    def __init__(self, log, kind, model):
        self.log, self.kind, self.model = log, kind, model

    def __getattr__(self, name):
        def record(*args, **kwargs):
            assert not args, f"{name} called with positional arguments {args}"
            kwargs = {k: _handle_path(v) for k, v in kwargs.items()}
            self.log.append((self.kind, name, kwargs, self.model.enabled_models,
                             sorted(self.model.frozen_paths)))
        return record


def _curriculum_log(run_curriculum, model):
    log = []
    run_curriculum(model, FakeBuddy(log), Recorder(log, "train", model),
                   Recorder(log, "eval", model))
    return log


@pytest.fixture(scope="module")
def jax_models():
    """The JAX door models of the port's types, their init traced
    (eval_shape) rather than compiled."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jwrappers.jax, "jit", lambda fn: lambda *a: jax.eval_shape(fn, *a))
        return {name: JaxDoorTask.model_types[name]() for name in PORT_TYPES}


def test_registry_holds_the_five_port_classes():
    """The registry holds every JAX door type (the test's name dates from
    the PF and LSTM classes, five; the Kalman filters made them ten)."""
    assert PORT_TYPES == sorted(JaxDoorTask.model_types)
    assert PORT_TYPES == ["DoorCrossmodalKalmanFilter", "DoorCrossmodalParticleFilter",
                          "DoorCrossmodalParticleFilterSeq5", "DoorKalmanFilter",
                          "DoorLSTMFilter", "DoorMeasurementCrossmodalKalmanFilter",
                          "DoorMeasurementUnimodalKalmanFilter", "DoorParticleFilter",
                          "DoorUnimodalKalmanFilter", "DoorUnimodalParticleFilter"]
    choices = next(a for a in train_door._parser()._actions if a.dest == "model_type").choices
    assert sorted(choices) == PORT_TYPES


@pytest.mark.parametrize("name", PORT_TYPES)
def test_curriculum_matches_jax(name, jax_models):
    want = _curriculum_log(_jax_train_door().run_curriculum, jax_models[name])
    got = _curriculum_log(train_door.run_curriculum,
                          DoorTask.model_types[name](device="cpu"))
    assert got == want
    assert any(entry[0] == "train" for entry in got)
    assert [e[1] for e in got if e[0] == "save"][-1] in (
        "phase1", "phase3", "phase4", "phase4-done", "phase4-final")


@pytest.fixture()
def cli_workspace(tmp_path, monkeypatch):
    """A working directory (Buddy's directories), an empty dataset cache and
    tiny synthetic door sets (one trajectory of 16-19 steps a file); sys's
    excepthook restored after (the CLI installs pdb_safety_net's)."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(sys, "excepthook", sys.excepthook)
    monkeypatch.setattr(cache, "_cache_path", None)  # the CLI sets it
    for key, value in (("MMF_TPU_SYNTHESIZE_DATA", "1"), ("MMF_TPU_SYNTH_T", "16"),
                       ("MMF_TPU_SYNTH_TRAJ", "1"), ("MMF_TPU_OFFLINE", "1"),
                       ("MMF_TPU_EVAL_DEVICE_THROUGHPUT", "0")):
        monkeypatch.setenv(key, value)
    monkeypatch.delenv("MMF_TPU_SERVING", raising=False)
    return tmp_path


@pytest.mark.parametrize("resume", [False, True])
def test_cli_wiring(cli_workspace, monkeypatch, resume):
    """main builds the named model on the named device, writes the JAX CLI's
    metadata, configures both helper modules on it, runs the curriculum
    (here a recorder) through ResumableCurriculum and ends with run_eval."""
    seen = []

    def recording(filter_model, buddy, train_helpers, eval_helpers):
        seen.append((filter_model, buddy, train_helpers, eval_helpers))
        buddy.save_checkpoint("phase0")

    monkeypatch.setattr(train_door, "run_curriculum", recording)
    argv = ["--model-type", "DoorParticleFilter", "--experiment-name", "wiring",
            "--notes", "a note", "--device", "cpu"] + (["--resume"] if resume else [])
    results = train_door.main(argv, cache_dir=str(cli_workspace / "cache"))

    # With --resume and no checkpoint, a probe pass, then the live run.
    assert len(seen) == (2 if resume else 1)
    model, buddy, train_helpers, eval_helpers = seen[-1]
    assert type(model) is tdoor.DoorParticleFilter and model.device.type == "cpu"
    assert teval.filter_model is model
    assert train_helpers.filter_model is model  # a proxy passes it through
    assert len(train_helpers.trajectories) == 2
    assert (cli_workspace / "checkpoints" / "wiring" / "phase0.pt").exists()
    meta = json.loads((cli_workspace / "metadata" / "wiring.json").read_text())
    assert set(meta) == METADATA_KEYS
    assert meta["model_type"] == "DoorParticleFilter" and meta["notes"] == "a note"
    assert meta["dataset_args"] == DoorTask.get_dataset_args(train_door._parser().parse_args(
        ["--model-type", "DoorParticleFilter", "--experiment-name", "x"]))
    assert results.keys() >= {"theta_rmse_deg", "x_rmse_cm", "y_rmse_cm"}
    assert meta["eval_results"]["theta_rmse_deg"] == results["theta_rmse_deg"]


# The ids are those the cases had when the parallelism flags were refused
# outright; each case now holds what the flag does in this test's world of
# one process.
@pytest.mark.parametrize("argv,raises,match", [
    (["--serving"], None, "A8"),
    (["--data-parallel", "2"], SystemExit, "torchrun --nproc-per-node 2"),
    (["--pipeline-stages", "2"], SystemExit, "torchrun --nproc-per-node 2"),
], ids=["argv0-NotImplementedError-A8", "argv1-NotImplementedError-A13",
        "argv2-NotImplementedError-A13"])
def test_cli_refuses_what_is_not_ported(cli_workspace, monkeypatch, argv, raises, match):
    """A parallelism flag asking for more devices than the world has (one
    process here) exits naming the torchrun launch it needs, and writes
    nothing, as the JAX CLI fails on too few devices (tests of the flags in
    a world of several ranks: test_torch_port_multidevice_cli.py).
    --serving, ported by A8, is honoured as the JAX CLI honours it:
    MMF_TPU_SERVING=1 (as JAX's apply_serving_arg sets it) before the model
    is built, so the curriculum receives a model whose def carries bf16
    encoders and the folded tail (the train loops strip them; eval keeps
    them)."""
    import argparse
    import os

    from multimodalfilter_tpu.parallel.cli import apply_serving_arg as jax_apply_serving_arg

    argv = ["--model-type", "DoorParticleFilter", "--experiment-name", "x", "--device",
            "cpu", *argv]
    if match != "A8":
        with pytest.raises(raises, match=match):
            train_door.main(argv, cache_dir=str(cli_workspace / "cache"))
        assert not (cli_workspace / "metadata").exists()
        assert not (cli_workspace / "checkpoints").exists()
        assert not (cli_workspace / "logs").exists()
        return
    monkeypatch.setenv("MMF_TPU_SERVING", "0")
    seen = []

    def recording(filter_model, buddy, train_helpers, eval_helpers):
        seen.append(filter_model.definition.measurement_model)
        buddy.save_checkpoint("phase0")

    monkeypatch.setattr(train_door, "run_curriculum", recording)
    monkeypatch.setattr(teval, "run_eval", lambda **kwargs: {})
    train_door.main(argv, cache_dir=str(cli_workspace / "cache"))
    port_env = os.environ["MMF_TPU_SERVING"]
    os.environ["MMF_TPU_SERVING"] = "0"
    jax_apply_serving_arg(argparse.Namespace(serving=True))
    assert port_env == os.environ["MMF_TPU_SERVING"] == "1"
    (mm,) = seen
    assert mm.dtype == torch.bfloat16 and mm.fold_tail


def test_cli_refuses_an_unregistered_model_type(cli_workspace, capsys):
    """A name that neither package registers is not a --model-type choice."""
    assert "DoorNoSuchFilter" not in JaxDoorTask.model_types
    with pytest.raises(SystemExit) as exc:
        train_door.main(["--model-type", "DoorNoSuchFilter", "--experiment-name", "x"])
    assert exc.value.code == 2
    assert "invalid choice: 'DoorNoSuchFilter'" in capsys.readouterr().err
