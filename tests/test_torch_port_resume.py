"""The port's curriculum resume (``crossmodal/resume.py``, ``--resume`` on the
train CLI), as ``tests/test_resume.py`` holds the JAX package's: completed
phases are skipped by their labeled checkpoints (``<label>.pt``), the
frontier checkpoint is restored before the first incomplete segment runs
again, and optimizers created after a restore warm-start from it.

The curriculum is the port's plain ``DoorParticleFilter`` branch of
``run_curriculum`` (phases ``phase0`` to ``phase3``), with helpers that log
each call and add 1 to the model's first parameter at each train call, so
each phase's checkpoint differs and a replay gives the same parameters.

``test_resume_matches_jax`` runs the JAX package's ``ResumableCurriculum``
beside the port's on the same checkpoint state: the door curricula of both
packages and one curriculum made of the cases the design has to handle
(repeated and unlabeled saves, surgery, a clear after the frontier, calls
after the last save). Both must make the same live calls, restore the same
label at the same place and report the same skips.
"""

import functools
import os
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import pytest
import torch

from crossmodal.resume import ResumableCurriculum as JaxResumableCurriculum
from crossmodal.tasks import DoorTask as JaxDoorTask
from multimodalfilter_tpu.filtering import wrappers as jwrappers

from multimodalfilter_tpu_torch.crossmodal import door_models as tdoor
from multimodalfilter_tpu_torch.crossmodal.resume import ResumableCurriculum
from multimodalfilter_tpu_torch.crossmodal.tasks import DoorTask
from multimodalfilter_tpu_torch.experiments import Buddy
from multimodalfilter_tpu_torch.scripts.door_task import train_door
from multimodalfilter_tpu_torch.train.optim import get_named_optimizer

REPO = Path(__file__).resolve().parents[1]

# DoorParticleFilter's curriculum (train_door.run_curriculum): the calls of
# each phase, up to and including its save.
PHASE_CALLS = {
    "phase0": ["train_pf_dynamics_single_step"],
    "phase1": ["train_pf_dynamics_recurrent"] * 3 + ["log_eval"],
    "phase2": ["train_pf_measurement", "log_eval"],
    "phase3": ["train_e2e", "log_eval"] * 6,
}


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


def _make_buddy(tmp_path, model, name="resume_test"):
    return Buddy(name, model, checkpoint_dir=str(tmp_path / "ckpt"),
                 metadata_dir=str(tmp_path / "meta"), log_dir=str(tmp_path / "logs"),
                 verbose=False)


class MutatingHelpers:
    """Stand-in train and eval helpers: log every call, and at each train
    call add 1 to the first parameter of the buddy's model."""

    def __init__(self, log, buddy):
        self.log = log
        self.buddy = buddy

    def __getattr__(self, name):
        def record(*args, **kwargs):
            self.log.append(name)
            if name.startswith("train"):
                with torch.no_grad():
                    next(self.buddy.model.params.parameters()).add_(1.0)

        return record


def _first_param(model):
    return next(model.params.parameters()).detach().clone()


@pytest.fixture(scope="module")
def initial_state():
    """One seeded model's parameters, shared by every run (building a model
    draws its init)."""
    return tdoor.DoorParticleFilter(device="cpu").params.state_dict()


def _run_pf_curriculum(tmp_path, initial_state, name, resume):
    model = tdoor.DoorParticleFilter(device="cpu")
    model.params.load_state_dict(initial_state)
    buddy = _make_buddy(tmp_path, model, name)
    log = []
    rc = ResumableCurriculum(buddy, MutatingHelpers(log, buddy),
                             MutatingHelpers(log, buddy), enabled=resume)
    rc.run(train_door.run_curriculum, model)
    return model, buddy, log


def test_fresh_resume_run_matches_plain(tmp_path, initial_state):
    """--resume with no checkpoints probes, then runs everything live: the
    same calls, checkpoints and final parameters as a plain run."""
    plain, _, log_plain = _run_pf_curriculum(tmp_path / "plain", initial_state, "pf", False)
    model, _, log = _run_pf_curriculum(tmp_path / "resumed", initial_state, "pf", True)
    assert log == log_plain == sum(PHASE_CALLS.values(), [])
    assert torch.equal(_first_param(model), _first_param(plain))
    for label in PHASE_CALLS:
        assert (tmp_path / "resumed" / "ckpt" / "pf" / f"{label}.pt").exists()


def test_resume_all_phases_complete(tmp_path, initial_state):
    """A finished run resumes with no train or eval call and ends with the
    final checkpoint's parameters restored."""
    model1, _, _ = _run_pf_curriculum(tmp_path, initial_state, "pf", False)
    final = _first_param(model1)
    model2, _, log2 = _run_pf_curriculum(tmp_path, initial_state, "pf", True)
    assert log2 == []
    assert torch.equal(_first_param(model2), final)
    assert not torch.equal(_first_param(model2), initial_state[next(iter(initial_state))])


def test_resume_from_partial_run(tmp_path, initial_state):
    """With the last checkpoint deleted (an interrupted run), only the last
    segment runs, from the restored frontier, and the final parameters equal
    the uninterrupted run's bit for bit."""
    model1, buddy1, log1 = _run_pf_curriculum(tmp_path, initial_state, "pf", False)
    final, steps = _first_param(model1), buddy1.optimizer_steps
    (tmp_path / "ckpt" / "pf" / "phase3.pt").unlink()

    model2, buddy2, log2 = _run_pf_curriculum(tmp_path, initial_state, "pf", True)
    assert log2 == PHASE_CALLS["phase3"]
    assert len(log2) < len(log1)
    assert torch.equal(_first_param(model2), final)
    assert buddy2.optimizer_steps == steps
    assert (tmp_path / "ckpt" / "pf" / "phase3.pt").exists()


def test_resume_surgery_defers_but_validates_eagerly(tmp_path, initial_state):
    """A skipped load_checkpoint_module raises what Buddy raises for a
    missing source checkpoint, FileNotFoundError, with a label and without
    (the crossmodal-PF curriculum's warm-start falls back on it)."""
    model = tdoor.DoorParticleFilter(device="cpu")
    buddy = _make_buddy(tmp_path, model, "surgery")
    rc = ResumableCurriculum(buddy, object(), object(), enabled=True)
    for label in (None, "phase9"):
        with pytest.raises(FileNotFoundError):
            buddy.load_checkpoint_module("dynamics_model", label=label,
                                         experiment_name="does_not_exist")
        with pytest.raises(FileNotFoundError):
            rc.buddy.load_checkpoint_module("dynamics_model", label=label,
                                            experiment_name="does_not_exist")
    # An existing source is validated and the load skipped.
    buddy.save_checkpoint("phase0")
    before = _first_param(model)
    with torch.no_grad():
        next(model.params.parameters()).add_(1.0)
    assert rc.buddy.load_checkpoint_module("dynamics_model", label="phase0") is None
    assert not torch.equal(_first_param(model), before)


def _adam_step(optimizer, module):
    for p in module.parameters():
        p.grad = torch.ones_like(p)
    optimizer.step()


def test_optimizer_warm_start_after_restore(tmp_path):
    """Optimizer states restored before their optimizer exists (on resume the
    train loops create optimizers lazily) warm-start get_named_optimizer;
    _optimizer_dict.clear() drops the stash."""
    module = torch.nn.Linear(3, 2)
    model = type("Model", (), {"params": module})()
    buddy = _make_buddy(tmp_path, model, "warm")
    opt = get_named_optimizer(buddy, "ekf", module)
    _adam_step(opt, module)
    saved = opt.state_dict()["state"]
    buddy.save_checkpoint("phase0")

    model2 = type("Model", (), {"params": torch.nn.Linear(3, 2)})()
    buddy2 = _make_buddy(tmp_path, model2, "warm")
    buddy2.load_checkpoint("phase0")
    assert "ekf" in buddy2._pending_optimizer_state
    restored = get_named_optimizer(buddy2, "ekf", model2.params).state_dict()["state"]
    assert "ekf" not in buddy2._pending_optimizer_state
    assert saved.keys() == restored.keys()
    for k in saved:
        assert saved[k]["exp_avg"].any()
        for field in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(saved[k][field], restored[k][field])

    buddy3 = _make_buddy(tmp_path, type("Model", (), {"params": torch.nn.Linear(3, 2)})(),
                         "warm")
    buddy3.load_checkpoint("phase0")
    assert "ekf" in buddy3._pending_optimizer_state
    buddy3._optimizer_dict.clear()
    assert buddy3._pending_optimizer_state == {}
    assert get_named_optimizer(buddy3, "ekf", buddy3.model.params).state_dict()["state"] == {}


def test_resume_replays_under_correct_mutation_state(tmp_path):
    """A replayed train call sees the model state of its own call site (the
    curricula change the model between train calls), not the state at the
    end of its segment."""

    def run(resume):
        model = type("Model", (), {"params": torch.nn.Linear(3, 2), "flag": "init"})()
        buddy = _make_buddy(tmp_path, model, "mut")
        seen = []

        class Helpers:
            def train_e2e(self, tag):
                seen.append((tag, model.flag))
                with torch.no_grad():
                    model.params.weight.add_(1.0)

            def log_eval(self):
                pass

        def curriculum(buddy, th, eh):
            model.flag = "A"
            th.train_e2e("t1")
            buddy.save_checkpoint("p0")
            model.flag = "B"
            th.train_e2e("t2")
            model.flag = "C"
            th.train_e2e("t3")
            buddy.save_checkpoint("p1")

        ResumableCurriculum(buddy, Helpers(), Helpers(), enabled=resume).run(curriculum)
        return model, seen

    model1, seen1 = run(resume=False)
    assert seen1 == [("t1", "A"), ("t2", "B"), ("t3", "C")]
    (tmp_path / "ckpt" / "mut" / "p1.pt").unlink()
    model2, seen2 = run(resume=True)
    assert seen2 == [("t2", "B"), ("t3", "C")]
    assert torch.equal(model2.params.weight, model1.params.weight)


def test_resume_optimizer_clear_not_resurrected(tmp_path):
    """A curriculum's _optimizer_dict.clear() inside the replayed segment
    still gives a fresh optimizer on resume: the frontier's restore stashes
    its optimizer states, and the clear, run after the restore, drops them."""

    def run(resume):
        model = type("Model", (), {"params": torch.nn.Linear(3, 2)})()
        buddy = _make_buddy(tmp_path, model, "optclear")
        warm_at_entry = []

        class Helpers:
            def train_e2e(self):
                opt = get_named_optimizer(buddy, "o", model.params)
                warm_at_entry.append(bool(opt.state_dict()["state"]))
                _adam_step(opt, model.params)

            def log_eval(self):
                pass

        def curriculum(buddy, th, eh):
            th.train_e2e()
            buddy.save_checkpoint("p0")
            buddy._optimizer_dict.clear()  # the curricula's phase reset
            th.train_e2e()
            buddy.save_checkpoint("p1")

        ResumableCurriculum(buddy, Helpers(), Helpers(), enabled=resume).run(curriculum)
        return warm_at_entry

    assert run(resume=False) == [False, False]
    (tmp_path / "ckpt" / "optclear" / "p1.pt").unlink()
    assert run(resume=True) == [False]


# --- The port's ResumableCurriculum against the JAX package's ---------------


def _jax_train_door():
    sys.path.insert(0, str(REPO / "scripts" / "door_task"))
    import train_door as jax_train_door

    return jax_train_door


def _touch(path):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    open(path, "w").close()


def _model_state(model):
    return (model.enabled_models, sorted(model.frozen_paths))


class _Clears(dict):
    def __init__(self, log):
        super().__init__()
        self.log = log

    def clear(self):
        self.log.append(("optimizers cleared",))
        super().clear()


class _FakeBuddy:
    """A buddy whose checkpoints are empty files under `root`: it logs live
    saves (and writes their file), restores and module loads, and raises for
    a missing source checkpoint what its package's Buddy raises."""

    experiment_name = "exp"

    def __init__(self, root, log, model):
        self._checkpoint_dir = str(root)
        self.log = log
        self.model = model
        self._optimizer_dict = _Clears(log)

    def _exp_dir(self, experiment_name=None):
        return os.path.join(self._checkpoint_dir, experiment_name or self.experiment_name)

    def save_checkpoint(self, label=None):
        self.log.append(("save", label, _model_state(self.model)))
        path = self._checkpoint_path(label)
        _touch(path)
        return path

    def load_checkpoint(self, label=None, experiment_name=None):
        self.log.append(("restore", label, experiment_name, _model_state(self.model)))

    def load_checkpoint_module(self, source, target=None, label=None, experiment_name=None):
        self._check_source(label, experiment_name)
        self.log.append(("load module", source, target, label, experiment_name))


class JaxFakeBuddy(_FakeBuddy):
    """The JAX Buddy's layout: ``<label>.ckpt`` from ``_checkpoint_base``; a
    missing unlabeled source raises AssertionError."""

    suffix = ".ckpt"

    def _checkpoint_base(self, label, experiment_name=None):
        return os.path.join(self._exp_dir(experiment_name), label or "unlabeled")

    def _checkpoint_path(self, label, experiment_name=None):
        return self._checkpoint_base(label, experiment_name) + ".ckpt"

    def _check_source(self, label, experiment_name):
        if label is not None:
            if not os.path.exists(self._checkpoint_path(label, experiment_name)):
                raise FileNotFoundError(label)
        elif not os.path.isdir(self._exp_dir(experiment_name)):
            raise AssertionError(experiment_name)


class PortFakeBuddy(_FakeBuddy):
    """The port's Buddy layout: ``<label>.pt`` from ``_checkpoint_path``; a
    missing source raises FileNotFoundError, labeled or not."""

    suffix = ".pt"

    def _checkpoint_path(self, label, experiment_name=None):
        return os.path.join(self._exp_dir(experiment_name), f"{label or 'unlabeled'}.pt")

    def _check_source(self, label, experiment_name):
        if not os.path.exists(self._checkpoint_path(label, experiment_name)) and (
                label is not None or not os.path.isdir(self._exp_dir(experiment_name))):
            raise FileNotFoundError(experiment_name)


def _handle_path(value):
    """A submodule handle (``model=filter_model.filter_models[0]``) by its
    dotted path, which both packages' handles carry; other values as they
    are."""
    if hasattr(value, "root") and hasattr(value, "path"):
        return ("handle", value.path)
    return value


class _Recorder:
    """A helper module whose every function logs its name and kwargs with
    the model's enabled modalities and frozen paths at the call."""

    def __init__(self, log, kind, model):
        self.log, self.kind, self.model = log, kind, model

    def __getattr__(self, name):
        def record(*args, **kwargs):
            assert not args, f"{name} called with positional arguments {args}"
            kwargs = {k: _handle_path(v) for k, v in kwargs.items()}
            self.log.append((self.kind, name, kwargs, _model_state(self.model)))
        return record


def edge_curriculum(model, buddy, train_helpers, eval_helpers, *, third_label, tail):
    """Every case the two-pass design has to handle: model changes between
    calls, a warm start whose fallback changes the model when its experiment
    is missing, labeled surgery, a clear after a save, a third save labeled
    `third_label` (a fresh label, a repeat or None), and after the last save
    the call `tail` (an eval, surgery or none)."""
    model.enabled_models = [True, False]
    train_helpers.train_e2e(subsequence_length=2)
    buddy.save_checkpoint("a")
    try:
        buddy.load_checkpoint_module("dynamics_model", experiment_name="warm")
    except (FileNotFoundError, AssertionError):
        model.frozen_paths.add("no_warm_start")
        train_helpers.train_pf_dynamics_single_step(epochs=1)
    buddy.load_checkpoint_module("measurement_model", label="a")
    model.frozen_paths.add("dynamics_model")
    train_helpers.train_e2e(subsequence_length=4)
    eval_helpers.log_eval()
    buddy.save_checkpoint("b")
    buddy._optimizer_dict.clear()
    model.enabled_models = [False, True]
    train_helpers.train_pf_measurement(epochs=1)
    buddy.save_checkpoint(third_label)
    model.frozen_paths.discard("dynamics_model")
    train_helpers.train_e2e(subsequence_length=8)
    buddy.save_checkpoint("d")
    if tail == "eval":
        eval_helpers.log_eval()
    elif tail == "surgery":
        buddy.load_checkpoint_module("measurement_model", label="b")


def _edge_model():
    return SimpleNamespace(enabled_models=[True, True], frozen_paths=set())


def _reset(model):
    """The state a model is built with: nothing frozen, every modality on."""
    model.frozen_paths.clear()
    if model.enabled_models is not None:
        model.enabled_models = [True] * len(model.enabled_models)


@pytest.fixture(scope="module")
def door_models():
    """(JAX, port) models of the PF and KF curricula with phase checkpoints
    and surgery, the JAX init traced (eval_shape) rather than compiled: the
    curricula never read a parameter."""
    names = ("DoorParticleFilter", "DoorCrossmodalParticleFilter",
             "DoorCrossmodalKalmanFilter", "DoorUnimodalKalmanFilter")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jwrappers.jax, "jit", lambda fn: lambda *a: jax.eval_shape(fn, *a))
        return {n: (JaxDoorTask.model_types[n](), DoorTask.model_types[n](device="cpu"))
                for n in names}


PF_LABELS = ["phase0", "phase1", "phase2", "phase3"]
CROSSMODAL_LABELS = ["phase1", "phase2", "phase3", "phase4"]
CMKF_LABELS = ["phase0", "phase1", "phase2", "phase3-image", "phase3-force",
               "phase4-freeze", "phase4-length3", "phase4-length4", "phase4-done"]
UKF_LABELS = ["phase0", "phase1", "phase2", "phase3", "phase4-length4", "phase4-final"]
EDGE_LABELS = ["a", "b", "c", "d"]

RESUME_CASES = [
    # (curriculum, labels whose checkpoint exists, warm-start experiment exists)
    ("DoorParticleFilter", [], False),
    ("DoorParticleFilter", PF_LABELS[:1], False),
    ("DoorParticleFilter", PF_LABELS[:3], False),
    ("DoorParticleFilter", PF_LABELS, False),
    ("DoorParticleFilter", PF_LABELS[1:], False),
    ("DoorCrossmodalParticleFilter", [], False),
    ("DoorCrossmodalParticleFilter", [], True),
    ("DoorCrossmodalParticleFilter", CROSSMODAL_LABELS[:1], False),
    ("DoorCrossmodalParticleFilter", CROSSMODAL_LABELS[:2], True),
    ("DoorCrossmodalParticleFilter", CROSSMODAL_LABELS[:3], False),
    ("DoorCrossmodalParticleFilter", CROSSMODAL_LABELS, False),
    ("DoorCrossmodalParticleFilter", CROSSMODAL_LABELS, True),
    # The KF curricula: surgery between the children after phases 0 and 1,
    # enabled switches, freezes of the tuple field filter_models.
    ("DoorCrossmodalKalmanFilter", [], False),
    ("DoorCrossmodalKalmanFilter", CMKF_LABELS[:1], False),
    ("DoorCrossmodalKalmanFilter", CMKF_LABELS[:4], False),
    ("DoorCrossmodalKalmanFilter", CMKF_LABELS[:6], False),
    ("DoorCrossmodalKalmanFilter", CMKF_LABELS, False),
    ("DoorCrossmodalKalmanFilter", CMKF_LABELS[1:], False),
    ("DoorUnimodalKalmanFilter", [], False),
    ("DoorUnimodalKalmanFilter", UKF_LABELS[:2], False),
    ("DoorUnimodalKalmanFilter", UKF_LABELS[:4], False),
    ("DoorUnimodalKalmanFilter", UKF_LABELS, False),
]
for third, tail in (("c", "eval"), ("a", "eval"), (None, "eval"), ("c", "surgery"), ("c", "none")):
    RESUME_CASES += [
        (f"edge:{third}:{tail}", labels, warm)
        for labels, warm in (([], False), (EDGE_LABELS[:1], False), (EDGE_LABELS[:2], False),
                             (EDGE_LABELS[:2], True), (EDGE_LABELS, False),
                             (EDGE_LABELS, True), (EDGE_LABELS[1:], False))
    ]


def _case_id(case):
    name, labels, warm = case
    return f"{name}-[{','.join(labels)}]" + ("-warm" if warm else "")


def _run_resume(rc_class, buddy_class, run_curriculum, model, root, labels, warm, capsys):
    """One --resume run of `run_curriculum` on `model` with the checkpoints
    of `labels` (and of the warm-start experiment if `warm`) on disk: the
    log of live calls, the controller's end state and what it printed."""
    _reset(model)
    log = []
    buddy = buddy_class(root, log, model)
    for label in labels:
        _touch(buddy._checkpoint_path(label))
    if warm:
        _touch(buddy._checkpoint_path("final", "pf_blackout0.0_q_tune"))
        _touch(buddy._checkpoint_path("final", "warm"))
    capsys.readouterr()
    rc = rc_class(buddy, _Recorder(log, "train", model), _Recorder(log, "eval", model),
                  enabled=True)
    rc.run(run_curriculum, model)
    end = {k: getattr(rc, k) for k in ("_mode", "_frontier", "_target", "_trailing",
                                       "_skipped", "_seen")}
    return log, end, capsys.readouterr().out.splitlines()


@pytest.mark.parametrize("case", RESUME_CASES, ids=_case_id)
def test_resume_matches_jax(case, door_models, tmp_path, capsys):
    """The same checkpoint state gives the same run in both packages: the
    live calls in order (each with its kwargs and the model's state), the
    saves, module loads and optimizer clears, the restored label and where
    it happens, the frontier, and the skip counts the probe prints."""
    name, labels, warm = case
    if name.startswith("edge:"):
        _, third, tail = name.split(":")
        run = functools.partial(edge_curriculum, third_label=None if third == "None" else third,
                                tail=tail)
        jax_model, port_model = _edge_model(), _edge_model()
        jax_run = port_run = run
    else:
        jax_model, port_model = door_models[name]
        jax_run, port_run = _jax_train_door().run_curriculum, train_door.run_curriculum
    want = _run_resume(JaxResumableCurriculum, JaxFakeBuddy, jax_run, jax_model,
                       tmp_path / "jax", labels, warm, capsys)
    got = _run_resume(ResumableCurriculum, PortFakeBuddy, port_run, port_model,
                      tmp_path / "port", labels, warm, capsys)
    assert got == want
    restores = [entry for entry in got[0] if entry[0] == "restore"]
    assert len(restores) == (got[1]["_frontier"] is not None)


@pytest.mark.parametrize("label", [None, "phase9"])
def test_skipped_surgery_raises_as_each_buddy_does(label, tmp_path):
    """A skipped load_checkpoint_module from a missing source raises in the
    probe what that package's Buddy raises: the JAX one AssertionError for
    an unlabeled source and FileNotFoundError for a labeled one, the port's
    FileNotFoundError in both cases."""
    for rc_class, buddy_class, error in (
            (JaxResumableCurriculum, JaxFakeBuddy,
             AssertionError if label is None else FileNotFoundError),
            (ResumableCurriculum, PortFakeBuddy, FileNotFoundError)):
        model = _edge_model()
        buddy = buddy_class(tmp_path / buddy_class.__name__, [], model)
        with pytest.raises(error):
            buddy.load_checkpoint_module("dynamics_model", label=label, experiment_name="gone")
        rc = rc_class(buddy, object(), object(), enabled=True)
        with pytest.raises(error) as exc:
            rc.buddy.load_checkpoint_module("dynamics_model", label=label,
                                            experiment_name="gone")
        assert type(exc.value) is error
