"""The port's asynchronous checkpoint backend (``Buddy(checkpoint_backend=
"orbax")`` or ``MMF_TPU_CKPT_BACKEND=orbax``) against the JAX package's
orbax backend: the counterparts of ``tests/test_orbax_checkpoint.py``'s six
tests, then what the asynchronous write itself must hold. A save copies the
state to the host and returns, the write commits by a rename on a writer
thread, reads wait for it, and its errors surface at the next wait, save or
read. Both backends write the same ``.pt`` file.
"""

import os
import sys
import threading
import time

import jax
import numpy as np
import pytest
import torch

from multimodalfilter_tpu.experiments import Buddy as JaxBuddy
from multimodalfilter_tpu_torch.experiments import Buddy, buddy as buddy_module
from multimodalfilter_tpu_torch.parallel.launch import spawn
from multimodalfilter_tpu_torch.train import optim

sys.path.insert(0, "tests")
import test_torch_port_dist_worker as worker  # noqa: E402

# The slowed-down write of the tests that read while it is in flight.
DELAY_S = 0.5


def _arrays(seed=0):
    r = np.random.default_rng(seed)
    return {"dynamics_model": {"w": r.normal(size=(4, 4)).astype(np.float32),
                               "b": np.zeros(4, np.float32)},
            "measurement_model": {"w": r.normal(size=(3, 4)).astype(np.float32)}}


def _buddy(tmp_path, name, model, backend=None, cls=Buddy):
    return cls(name, model, checkpoint_dir=str(tmp_path / "ckpt"),
               metadata_dir=str(tmp_path / "meta"), log_dir=str(tmp_path / "logs"),
               checkpoint_backend=backend, verbose=False)


def _state(model):
    return {k: v.detach().clone() for k, v in model.params.state_dict().items()}


@pytest.fixture()
def slow_writes(monkeypatch):
    """Writes that start DELAY_S late, so that the test acts while one is
    in flight."""
    real = buddy_module._write_atomically

    def slow(state, path):
        time.sleep(DELAY_S)
        real(state, path)

    monkeypatch.setattr(buddy_module, "_write_atomically", slow)


def test_async_roundtrip_params_steps_and_optimizer(tmp_path):
    model = worker.TinyParams(_arrays())
    buddy = _buddy(tmp_path, "rt", model, backend="orbax")
    opt = optim.get_named_optimizer(buddy, "phase1", model.params)
    for p in model.params.parameters():
        p.grad = torch.ones_like(p)
    opt.step()
    buddy.increment_steps(7)
    original = _state(model)
    saved_moments = {k: v.clone() for k, v in opt.state_dict()["state"][0].items()}

    path = buddy.save_checkpoint("unit")
    assert path.endswith("unit.pt")
    buddy.wait_for_checkpoints()

    with torch.no_grad():
        for p in model.params.parameters():
            p.add_(1.0)
    buddy._steps = 0
    opt.step()
    buddy.load_checkpoint("unit")
    for k, v in _state(model).items():
        assert torch.equal(v, original[k]), k
    assert buddy.optimizer_steps == 7
    for k, v in opt.state_dict()["state"][0].items():
        assert torch.equal(v, saved_moments[k]), k


def test_async_saved_read_by_sync_buddy_and_module_surgery(tmp_path):
    model = worker.TinyParams(_arrays())
    writer = _buddy(tmp_path, "interop", model, backend="orbax")
    writer.save_checkpoint("phase0")
    writer.wait_for_checkpoints()

    model2 = worker.TinyParams(_arrays(seed=1))
    reader = _buddy(tmp_path, "interop", model2)
    reader.load_checkpoint_module("dynamics_model", label="phase0")
    assert torch.equal(model2.params["dynamics_model"]["w"], model.params["dynamics_model"]["w"])
    assert not torch.allclose(model2.params["measurement_model"]["w"],
                              model.params["measurement_model"]["w"])
    reader.load_checkpoint(label="phase0")
    assert torch.equal(model2.params["measurement_model"]["w"],
                       model.params["measurement_model"]["w"])


def test_sync_saved_read_by_async_buddy(tmp_path):
    model = worker.TinyParams(_arrays())
    _buddy(tmp_path, "interop2", model).save_checkpoint("phase0")
    model2 = worker.TinyParams(_arrays(seed=1))
    _buddy(tmp_path, "interop2", model2, backend="orbax").load_checkpoint(label="phase0")
    assert torch.equal(model2.params["dynamics_model"]["w"], model.params["dynamics_model"]["w"])


def test_latest_fallback_spans_both_backends(tmp_path):
    """``load_checkpoint()`` with no label takes the newest checkpoint,
    whichever backend wrote it."""
    model = worker.TinyParams(_arrays())
    buddy = _buddy(tmp_path, "latest", model, backend="orbax")
    buddy._checkpoint_backend = "msgpack"
    old = buddy.save_checkpoint("old")
    with torch.no_grad():
        for p in model.params.parameters():
            p.mul_(2.0)
    newer = _state(model)
    buddy._checkpoint_backend = "orbax"
    path = buddy.save_checkpoint("new")
    buddy.wait_for_checkpoints()
    t = os.path.getmtime(old) + 2
    os.utime(path, (t, t))
    with torch.no_grad():
        for p in model.params.parameters():
            p.zero_()
    buddy.load_checkpoint()
    for k, v in _state(model).items():
        assert torch.equal(v, newer[k]), k


@pytest.mark.parametrize("how", ["argument", "environment"])
def test_unknown_backend_rejected(tmp_path, monkeypatch, how):
    model = worker.TinyParams(_arrays())
    if how == "environment":
        monkeypatch.setenv("MMF_TPU_CKPT_BACKEND", "flatbuffer")
    with pytest.raises(ValueError, match="msgpack.*orbax"):
        _buddy(tmp_path, "bad", model, backend="flatbuffer" if how == "argument" else None)


def test_missing_label_raises_filenotfound(tmp_path):
    buddy = _buddy(tmp_path, "missing", worker.TinyParams(_arrays()), backend="orbax")
    with pytest.raises(FileNotFoundError):
        buddy.load_checkpoint("nope")


def test_in_place_change_after_save_is_not_in_the_checkpoint(tmp_path, slow_writes):
    """The parameters and the Adam moments as they were when the save
    returned, though an optimizer step overwrote both in place while the
    write was in flight; the read waits for the commit."""
    model = worker.TinyParams(_arrays())
    buddy = _buddy(tmp_path, "snapshot", model, backend="orbax")
    opt = optim.get_named_optimizer(buddy, "e2e", model.params)
    for p in model.params.parameters():
        p.grad = torch.ones_like(p)
    opt.step()
    before = _state(model)
    moments = {k: v.clone() for k, v in opt.state_dict()["state"][0].items()}
    t0 = time.perf_counter()
    path = buddy.save_checkpoint("phase")
    assert time.perf_counter() - t0 < DELAY_S and not os.path.exists(path)
    opt.step()
    reader = _buddy(tmp_path, "snapshot", worker.TinyParams(_arrays(seed=1)))
    buddy.wait_for_checkpoints()
    state = torch.load(path, weights_only=True)
    for k, v in state["params"].items():
        assert torch.equal(v, before[k]) and not torch.equal(v, model.params.state_dict()[k]), k
    for k, v in state["optimizers"]["e2e"]["state"][0].items():
        assert torch.equal(v, moments[k]), k
    reader.load_checkpoint("phase")
    assert all(torch.equal(v, before[k]) for k, v in _state(reader.model).items())
    assert os.listdir(os.path.dirname(path)) == ["phase.pt"]  # no temporary file left


@pytest.mark.parametrize("where", ["wait", "save", "read"])
def test_writer_error_is_raised_at_the_next_wait_save_or_read(tmp_path, monkeypatch, where):
    model = worker.TinyParams(_arrays())
    buddy = _buddy(tmp_path, "failing", model, backend="orbax")

    def failing(state, path):
        raise OSError("disk full")

    monkeypatch.setattr(buddy_module.torch, "save", failing)
    path = buddy.save_checkpoint("lost")
    with pytest.raises(OSError, match="disk full"):
        if where == "wait":
            buddy.wait_for_checkpoints()
        elif where == "save":
            buddy.save_checkpoint("next")
        else:
            buddy.load_checkpoint("lost")
    buddy.wait_for_checkpoints()  # raised once
    assert not os.path.exists(path) and os.listdir(os.path.dirname(path)) == []


@pytest.mark.parametrize("value", ["orbax", "msgpack"])
def test_the_environment_selects_the_backend(tmp_path, monkeypatch, slow_writes, value):
    """MMF_TPU_CKPT_BACKEND=orbax: the save returns with its write in
    flight; msgpack: the file is there when it returns."""
    monkeypatch.setenv("MMF_TPU_CKPT_BACKEND", value)
    buddy = _buddy(tmp_path, "env", worker.TinyParams(_arrays()))
    path = buddy.save_checkpoint("phase")
    assert os.path.exists(path) == (value == "msgpack")
    buddy.wait_for_checkpoints()
    assert os.path.exists(path)


def test_two_rank_world_saves_async_and_reads_on_both_ranks(tmp_path):
    """A gloo world of 2: rank 0 alone writes, slowly; both ranks read what
    it wrote (the labelled checkpoint, then one submodule of another)
    without hanging, and neither reads before the commit."""
    arrays = _arrays()
    inputs = {"arrays": arrays, "delay_s": DELAY_S, "ckpt": str(tmp_path / "ckpt"),
              "meta": str(tmp_path / "meta"), "logs": str(tmp_path / "logs")}
    ranks = spawn(worker.async_checkpoint_rank, 2, "cpu", inputs, timeout_s=60)
    for out in ranks:
        assert out["steps"] == 3
        assert out["files"] == ["first.pt", "second.pt"]
        for k, v in out["first"].items():
            assert torch.equal(v, out["saved"][k]), k
        for k, v in out["surgery"].items():
            want = out["saved"][k] * 2.0 + 1.0 if k.startswith("measurement") else out["saved"][k]
            assert torch.equal(v, want), k


def test_the_same_sequence_through_jax_and_the_port(tmp_path):
    """Saves, in-place changes, loads and module surgery through the JAX
    Buddy (orbax) and the port's (orbax) from the same parameters leave the
    same parameters."""
    arrays = _arrays()
    jmodel = type("JaxModel", (), {})()
    jmodel.params = jax.tree_util.tree_map(jax.numpy.asarray, arrays)
    jbuddy = _buddy(tmp_path / "jax", "seq", jmodel, backend="orbax", cls=JaxBuddy)
    tmodel = worker.TinyParams(arrays)
    tbuddy = _buddy(tmp_path / "port", "seq", tmodel, backend="orbax")

    def change(scale):
        jmodel.params = jax.tree_util.tree_map(lambda a: a * scale + 1.0, jmodel.params)
        with torch.no_grad():
            for p in tmodel.params.parameters():
                p.mul_(scale).add_(1.0)

    for b in (jbuddy, tbuddy):
        b.save_checkpoint("phase0")
    change(2.0)
    for b in (jbuddy, tbuddy):
        b.save_checkpoint("phase1")
    change(-3.0)
    for b in (jbuddy, tbuddy):
        b.load_checkpoint_module("dynamics_model", label="phase0")
        b.load_checkpoint_module("measurement_model.w", label="phase1")
    for part, leaves in arrays.items():
        for k in leaves:
            np.testing.assert_array_equal(tmodel.params[part][k].detach().numpy(),
                                          np.asarray(jmodel.params[part][k]))
    change(0.5)
    for b in (jbuddy, tbuddy):
        b.load_checkpoint("phase1")
        b.wait_for_checkpoints()
    for part, leaves in arrays.items():
        for k in leaves:
            np.testing.assert_array_equal(tmodel.params[part][k].detach().numpy(),
                                          np.asarray(jmodel.params[part][k]))
