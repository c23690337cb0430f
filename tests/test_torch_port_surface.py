"""The rest of the port's surface against the JAX package on the CPU:
``ops.resampling.systematic_resample``, ``utils`` (``pytree``,
``slice_wrapper``, ``conversions``, ``rng``, ``debug``'s ``profile_trace``
and ``checkify_filter_step``), ``crossmodal.base_models``, ``native``, and
the scripts ``door_task/eval_dynamics.py``, ``door_task/vis_pf_likelihoods.py``,
``validate_curricula.py``, ``door_task/data_collection`` and
``export_serving.py`` (with a bundle run in a process that imports no model
code).

Tolerances: systematic indices equal where no position lies within 1e-6 of
a CDF entry (the two packages sum the CDF in other orders); the native
functions, the pytree and wrapper operations and the collected trajectory
files bitwise; the dynamics rollout's RMSE within 1e-5 of its scale (fp32
trunks rounding differently over 39 steps, as ``test_torch_port_eval.py``
holds ``run_eval``) and the likelihood grid within 1e-5 of its scale (the
same fp32 nets, sums in other orders).
"""

import dataclasses
import json
import os
import subprocess
import sys
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import crossmodal.base_models as jbase
import crossmodal.eval_helpers as jeval
import multimodalfilter_tpu.data.cache as jcache
from crossmodal.tasks import DoorTask as JaxDoorTask
from crossmodal.tasks import PushTask as JaxPushTask
from multimodalfilter_tpu import native as jnative
from multimodalfilter_tpu import utils as jutils
from multimodalfilter_tpu.data import TrajectoriesFile as JaxTrajectoriesFile
from multimodalfilter_tpu.experiments import Buddy as JaxBuddy
from multimodalfilter_tpu.filtering import wrappers as jwrappers
from multimodalfilter_tpu.ops.resampling import systematic_resample as jax_systematic
from multimodalfilter_tpu_torch import native, utils
from multimodalfilter_tpu_torch.crossmodal import base_models
from multimodalfilter_tpu_torch.crossmodal import door_models as tdoor
from multimodalfilter_tpu_torch.data import TrajectoriesFile, cache, synthetic
from multimodalfilter_tpu_torch.experiments import Buddy
from multimodalfilter_tpu_torch.experiments.export import load_serving_bundle
from multimodalfilter_tpu_torch.filtering import fusion
from multimodalfilter_tpu_torch.ops import pf_kernels
from multimodalfilter_tpu_torch.ops.resampling import systematic_resample
from multimodalfilter_tpu_torch.scripts import export_serving, validate_curricula
from multimodalfilter_tpu_torch.scripts.door_task import eval_dynamics, vis_pf_likelihoods
from multimodalfilter_tpu_torch.scripts.door_task.data_collection import (
    simulate_door,
    waypoint_policies,
)
from multimodalfilter_tpu_torch.types import Trajectory

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts", "door_task", "data_collection"))
import simulate_door as jax_simulate_door  # noqa: E402
import waypoint_policies as jax_waypoint_policies  # noqa: E402

TIE = 1e-6
RTOL = 1e-5
EVAL_FILES = ("panda_door_pull_10.hdf5", "panda_door_push_10.hdf5")
DATASET_ARGS = dict(use_vision=True, use_proprioception=True, use_haptics=True,
                    image_blackout_ratio=0.0, sequential_image_rate=1)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread while this module runs (the suite runs in several
    worker processes at once). Restored after the module."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_model(name, seed=0):
    """A JAX door model with its init traced (eval_shape), not compiled, and
    numpy weights: kernels of variance 1/fan_in, biases 0.1 sigma."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jwrappers.jax, "jit", lambda fn: lambda *a: jax.eval_shape(fn, *a))
        jm = JaxDoorTask.model_types[name]()
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        if path[-1].key == "bias":
            return (0.1 * rng.normal(size=leaf.shape)).astype(np.float32)
        fan_in = int(np.prod(leaf.shape[:-1]))
        return (rng.normal(size=leaf.shape) / np.sqrt(fan_in)).astype(np.float32)

    jm.params = jax.tree_util.tree_map_with_path(draw, jm.params)
    return jm


def _scale(x):
    return max(1.0, float(np.abs(np.asarray(x)).max()))


# -- systematic resampling ------------------------------------------------------


def test_systematic_resample_matches_jax():
    n, m, d = 4, 32, 3
    rng = np.random.default_rng(0)
    particles = rng.normal(size=(n, m, d)).astype(np.float32)
    particles[..., 0] = np.arange(m)  # each particle carries its slot
    log_weights = np.asarray(jax.nn.log_softmax(rng.normal(size=(n, m)).astype(np.float32)))
    key = jax.random.PRNGKey(3)
    jp, jlw = jax_systematic(key, jnp.asarray(particles), jnp.asarray(log_weights))
    u0 = torch.from_numpy(np.asarray(jax.random.uniform(key, (n, 1))))  # JAX's draw
    tp, tlw = systematic_resample(torch.from_numpy(particles),
                                  torch.from_numpy(log_weights), u0=u0)
    np.testing.assert_array_equal(tlw.numpy(), np.asarray(jlw))
    positions = (u0 + torch.arange(m)[None]) / m
    cdf = torch.cumsum(torch.exp(torch.from_numpy(log_weights)), dim=1)
    off_tie = pf_kernels.tie_gaps(cdf / cdf[:, -1:], positions).numpy() > TIE
    assert off_tie.mean() > 0.9
    idx_t, idx_j = tp[..., 0].numpy(), np.asarray(jp)[..., 0]
    np.testing.assert_array_equal(idx_t[off_tie], idx_j[off_tie])
    assert (np.diff(idx_t, axis=1) >= 0).all()  # sorted indices
    # One uniform a row from a generator: the same as passing its draw.
    drawn = systematic_resample(torch.from_numpy(particles), torch.from_numpy(log_weights),
                                generator=torch.Generator().manual_seed(1))[0]
    u0 = torch.rand((n, 1), generator=torch.Generator().manual_seed(1))
    given = systematic_resample(torch.from_numpy(particles), torch.from_numpy(log_weights),
                                u0=u0)[0]
    assert torch.equal(drawn, given)


# -- utils -----------------------------------------------------------------------


def _tree():
    return {"filter_models": {"0": {"dynamics_model": {"w": 1, "b": 2}},
                              "1": {"virtual_sensor_model": {"w": 3}}},
            "crossmodal_weight_model": {"w": 4}}


@pytest.mark.parametrize("path", ["filter_models.0.dynamics_model", "filter_models",
                                  "crossmodal_weight_model.w", "", "filter_models.2"])
def test_pytree_paths_match_jax(path):
    assert utils.torch_path_segments(path) == jutils.torch_path_segments(path)
    for fn in ("get_by_path", "set_by_path"):
        args = (_tree(), path) if fn == "get_by_path" else (_tree(), path, {"new": 0})
        try:
            want = getattr(jutils, fn)(*args)
        except KeyError as exc:
            with pytest.raises(KeyError, match=str(exc)[1:20]):
                getattr(utils, fn)(*args)
            continue
        tree = args[0]
        assert getattr(utils, fn)(*args) == want
        assert tree == _tree()  # set_by_path copies
    for key in [("filter_models", "0", "dynamics_model", "w"), ("filter_models",), ()]:
        assert utils.path_matches_prefix(key, path) == jutils.path_matches_prefix(key, path)


def test_slice_wrapper_matches_jax():
    rng = np.random.default_rng(0)
    data = {"a": rng.normal(size=(5, 3)), "b": rng.normal(size=(5, 3, 2))}
    for make in (lambda d: d, lambda d: d["a"]):
        tw, jw = utils.SliceWrapper(make(dict(data))), jutils.SliceWrapper(make(dict(data)))
        assert len(tw) == len(jw) and tw.shape == jw.shape
        for index in (1, slice(1, 4), np.array([0, 2])):
            got, want = tw[index], jw[index]
            if isinstance(want, dict):
                assert got.keys() == want.keys()
                assert all(np.array_equal(got[k], want[k]) for k in want)
            else:
                np.testing.assert_array_equal(got, want)
        np.testing.assert_equal(tw.map(lambda v: v * 2).data, jw.map(lambda v: v * 2).data)
    lists_t, lists_j = utils.SliceWrapper({}), jutils.SliceWrapper({})
    for w in (lists_t, lists_j):
        w.append({"x": 1, "y": 2})
        w.extend(utils.SliceWrapper({"x": [3, 4]}) if w is lists_t
                 else jutils.SliceWrapper({"x": [3, 4]}))
        w.append({"y": 6})
    assert lists_t.data == lists_j.data and list(lists_t.keys()) == list(lists_j.keys())


class _Pair(NamedTuple):
    first: object
    second: object


def test_conversions_match_jax():
    rng = np.random.default_rng(1)
    tree = {"a": rng.normal(size=(2, 3)).astype(np.float32),
            "b": [rng.normal(size=(4,)).astype(np.float32), "text", 3],
            "c": _Pair(rng.normal(size=(1,)).astype(np.float32), (np.float32(2.5),))}
    on_device = utils.to_device(tree, device="cpu")
    assert isinstance(on_device["a"], torch.Tensor) and isinstance(on_device["c"], _Pair)
    assert on_device["b"][1:] == ["text", 3]
    got = utils.to_numpy(on_device)
    want = jutils.to_numpy(jutils.to_device(tree))
    flat_got, spec_got = jax.tree_util.tree_flatten(got)
    flat_want, spec_want = jax.tree_util.tree_flatten(want)
    assert spec_got == spec_want
    for g, w in zip(flat_got, flat_want):
        np.testing.assert_array_equal(g, w)
    assert isinstance(utils.to_device(torch.ones(2)), torch.Tensor)


@pytest.mark.parametrize("value,accepted", [
    (None, True), ("0", True), ("off", True), ("OFF ", True), ("", True),
    ("1", False), ("rbg", False), ("unsafe_rbg", False), ("threefry", False)])
def test_rbg_knob(monkeypatch, value, accepted):
    """MMF_TPU_RBG: unset, 0 and off leave the default; every other value
    raises, here and when a filter is built."""
    if value is None:
        monkeypatch.delenv("MMF_TPU_RBG", raising=False)
    else:
        monkeypatch.setenv("MMF_TPU_RBG", value)
    if accepted:
        assert utils.prng_impl_from_env() is None
        assert utils.configure_prng_from_env() is None
        return
    with pytest.raises(NotImplementedError, match="MMF_TPU_RBG"):
        utils.prng_impl_from_env()
    with pytest.raises(NotImplementedError, match="MMF_TPU_RBG"):
        tdoor.DoorLSTMFilter(device="cpu")


def test_checkify_filter_step_flags_nan():
    model = tdoor.DoorParticleFilter(device="cpu").eval()
    defn = dataclasses.replace(model.definition, num_particles_eval=8)
    rng = np.random.default_rng(2)
    obs = {"image": rng.normal(size=(2, 32, 32)), "gripper_pos": rng.normal(size=(2, 3)),
           "gripper_sensors": rng.normal(size=(2, 7))}
    obs = model._to_device(obs)
    ctrl = model._to_device(rng.normal(size=(2, 7)))
    belief = defn.initialize_beliefs(torch.zeros(2, 3), 0.1 * torch.eye(3).repeat(2, 1, 1),
                                     train=False, generator=torch.Generator().manual_seed(0))
    step = utils.checkify_filter_step(lambda b: defn.step(b, obs, ctrl, train=False))
    error, (new_belief, estimate) = step(belief)
    assert error.get() is None and torch.isfinite(estimate).all()
    error.throw()
    belief.particles[1, 3, 0] = float("nan")
    error, _ = step(belief)
    assert "result[1]" in error.get()
    with pytest.raises(FloatingPointError, match="non-finite"):
        error.throw()


def test_profile_trace_writes_a_trace(tmp_path):
    with utils.profile_trace(str(tmp_path / "on")):
        torch.ones(64, 64) @ torch.ones(64, 64)
    with open(tmp_path / "on" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)
    with utils.profile_trace(str(tmp_path / "off"), enabled=False) as prof:
        assert prof is None
    assert not (tmp_path / "off").exists()


def test_base_models_aliases_match_jax():
    names = [n for n in dir(jbase) if not n.startswith("_")]
    assert sorted(base_models.__all__) == sorted(
        n for n in names if n[0].isupper() or n == "weighted_average")
    jax_fusion = sys.modules["multimodalfilter_tpu.filtering.fusion"]
    for name in base_models.__all__:
        port, ref = getattr(base_models, name), getattr(jbase, name)
        assert port is getattr(fusion, ref.__name__)
        assert ref is getattr(jax_fusion, ref.__name__)


# -- native ----------------------------------------------------------------------


def test_native_functions_match_jax_bitwise():
    """The inputs of tests/test_native_engine.py through each function of
    both packages (the JAX package's C++ engine where it is built)."""
    rng = np.random.default_rng(1234)
    assert not native.available() and "card" in native.build_error()
    for trail in [(7,), (4, 5), (32, 32)]:
        src = rng.standard_normal((300,) + trail).astype(np.float32)
        starts = rng.integers(0, 290, size=41).astype(np.int64)
        np.testing.assert_array_equal(native.window_gather(src, starts, 10),
                                      jnative.window_gather(src, starts, 10))
    src = rng.standard_normal((64, 3)).astype(np.float32)
    starts = np.arange(0, 55, 1, dtype=np.int64)
    np.testing.assert_array_equal(native.window_gather(src, starts, 10),
                                  jnative.window_gather(src, starts, 10))
    assert native.window_gather(src, np.empty(0, np.int64), 10).shape == (0, 10, 3)
    ints = rng.integers(0, 9, size=(20, 2))  # another dtype, preserved
    np.testing.assert_array_equal(native.window_gather(ints, np.array([0, 3]), 4),
                                  jnative.window_gather(ints, np.array([0, 3]), 4))
    with pytest.raises(ValueError, match="out of bounds"):
        native.window_gather(src, np.array([60]), 10)
    src = rng.standard_normal((1000, 13)).astype(np.float32)
    idx = rng.integers(0, 1000, size=4097).astype(np.int64)
    np.testing.assert_array_equal(native.row_gather(src, idx), jnative.row_gather(src, idx))
    x = rng.standard_normal((2048, 7)).astype(np.float32) * 50
    mean = rng.standard_normal(7).astype(np.float32)
    std = (rng.random(7).astype(np.float32) + 0.1) * 3
    np.testing.assert_array_equal(native.normalize(x, mean, std),
                                  jnative.normalize(x, mean, std))
    for hw in [(64, 64), (63, 65), (2, 2)]:
        img = rng.standard_normal((17,) + hw).astype(np.float32)
        np.testing.assert_array_equal(native.subsample2(img), jnative.subsample2(img))
    img = rng.standard_normal((40, 32, 32)).astype(np.float32)
    keep = (rng.random(40) > 0.4).astype(np.float32).reshape(40, 1, 1)
    np.testing.assert_array_equal(native.apply_mask(img, keep), jnative.apply_mask(img, keep))
    arrays = [rng.standard_normal((int(t), 32, 32)).astype(np.float32)
              for t in rng.integers(50, 90, size=7)]
    t_min = min(a.shape[0] for a in arrays)
    np.testing.assert_array_equal(native.stack_axis1(arrays, t_min),
                                  jnative.stack_axis1(arrays, t_min))


# -- scripts ---------------------------------------------------------------------


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    path = tmp_path_factory.mktemp("door_eval_cache")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MMF_TPU_SYNTH_T", "40")
        mp.setenv("MMF_TPU_SYNTH_TRAJ", "2")
        for seed, name in enumerate(EVAL_FILES):
            synthetic.synthesize_named_dataset(name, str(path / name), seed=seed)
    return path


def test_eval_dynamics_matches_jax(data_dir, tmp_path, monkeypatch):
    """The script on a checkpoint against the JAX package's
    run_eval(eval_dynamics=True) with the same weights and eval set."""
    monkeypatch.setenv("MMF_TPU_OFFLINE", "1")
    monkeypatch.setenv("MMF_TPU_EVAL_DEVICE_THROUGHPUT", "0")
    monkeypatch.setattr(jcache, "_cache_path", str(data_dir))
    monkeypatch.setattr(cache, "_cache_path", cache._cache_path)
    monkeypatch.chdir(tmp_path)
    jm = _jax_model("DoorKalmanFilter", seed=4)
    model = tdoor.DoorKalmanFilter(device="cpu")
    model.load_jax_params(jm.params)
    buddy = Buddy("eval_dynamics_test", model, verbose=False)
    buddy.set_metadata({"model_type": "DoorKalmanFilter", "dataset_args": DATASET_ARGS})
    buddy.save_checkpoint(label="final")
    got = eval_dynamics.main(["--experiment-name", "eval_dynamics_test", "--device", "cpu"],
                             cache_dir=str(data_dir))
    jbuddy = JaxBuddy("eval_dynamics_jax", jm, checkpoint_dir=str(tmp_path / "jc"),
                      metadata_dir=str(tmp_path / "jm"), log_dir=str(tmp_path / "jl"),
                      verbose=False)
    jeval.configure(buddy=jbuddy, task=JaxDoorTask, dataset_args=dict(DATASET_ARGS))
    want = jeval.run_eval(eval_dynamics=True)
    assert got.keys() == want.keys()
    np.testing.assert_allclose(got["raw_rmse"], want["raw_rmse"],
                               atol=RTOL * _scale(want["raw_rmse"]), rtol=0)


def test_likelihood_grid_matches_jax(tmp_path, monkeypatch):
    """The grid of each modality and the fused one against the JAX
    script's computation (vis_pf_likelihoods.py:66-98 of the JAX package),
    then the rendering, and its refusal without matplotlib."""
    jm = _jax_model("DoorCrossmodalParticleFilter", seed=5)
    model = tdoor.DoorCrossmodalParticleFilter(device="cpu")
    model.load_jax_params(jm.params)
    rng = np.random.default_rng(6)
    t_len, g = 6, 5
    traj = Trajectory(
        rng.normal(size=(t_len, 3)).astype(np.float32),
        {"image": rng.normal(size=(t_len, 32, 32)).astype(np.float32),
         "gripper_pos": rng.normal(size=(t_len, 3)).astype(np.float32),
         "gripper_sensors": rng.normal(size=(t_len, 7)).astype(np.float32)},
        rng.normal(size=(t_len, 7)).astype(np.float32))
    grid = vis_pf_likelihoods.likelihood_grid(model, traj, timestep=50, grid_size=g,
                                              grid_radius=1.5, dims=(0, 2))
    assert grid["timestep"] == t_len - 1 and grid["names"] == ["image", "pos+sensors"]

    # The JAX script's own computation.
    t = t_len - 1
    axis = np.linspace(-1.5, 1.5, g, dtype=np.float32)
    states = np.tile(traj.states[t], (g * g, 1))
    xs, ys = np.meshgrid(axis, axis)
    states[:, 0] += xs.ravel()
    states[:, 2] += ys.ravel()
    observations = {k: v[t:t + 1] for k, v in traj.observations.items()}
    mm_def, mm_params = jm.definition.measurement_model, jm.params["measurement_model"]
    np.testing.assert_array_equal(grid["axis"], axis)
    for i, sub in enumerate(mm_def.measurement_models):
        want = np.asarray(sub.log_likelihoods(mm_params["measurement_models"][str(i)],
                                              states[None], observations)).reshape(g, g)
        np.testing.assert_allclose(grid["log_likelihoods"][i], want,
                                   atol=RTOL * _scale(want), rtol=0)
    want = np.asarray(mm_def.log_likelihoods(mm_params, states[None], observations))
    np.testing.assert_allclose(grid["fused"], want.reshape(g, g),
                               atol=RTOL * _scale(want), rtol=0)

    out = vis_pf_likelihoods.render(grid, str(tmp_path / "grid.png"))
    assert os.path.getsize(out) > 0
    monkeypatch.setitem(sys.modules, "matplotlib", None)  # as if not installed
    with pytest.raises(ImportError, match="matplotlib"):
        vis_pf_likelihoods.render(grid, str(tmp_path / "again.png"))


def test_validate_curricula_run_one(tmp_path, monkeypatch):
    """run_one builds each class's train and eval commands (the door or
    push CLIs as modules, the device, the synthetic-data environment) and
    writes its JSON line with the eval's RMSE statistics; a failure records
    the output's tail. Nothing is trained: subprocess.run is stubbed."""
    classes = validate_curricula.registry_classes()
    assert sorted(classes[:10]) == sorted(JaxDoorTask.model_types)
    assert sorted(classes[10:]) == sorted(JaxPushTask.model_types) and len(classes) == 20
    calls = []

    def fake_run(cmd, *, env, cwd, capture_output, text, timeout):
        calls.append((cmd, env, cwd, timeout))
        if "--save" in cmd:
            os.makedirs(os.path.join(cwd, "metadata"), exist_ok=True)
            with open(os.path.join(cwd, "metadata", f"{cmd[cmd.index('--experiment-name') + 1]}"
                                   ".json"), "w") as f:
                json.dump({"eval_results_stats": {"x_rmse_cm_mean": 1.5,
                                                  "filter_steps_per_sec_mean": 9.0}}, f)
        failed = "PushLSTMFilter" in cmd
        return type("Done", (), {"returncode": 1 if failed else 0, "stdout": "out",
                                 "stderr": "boom" if failed else ""})()

    monkeypatch.setattr(validate_curricula.subprocess, "run", fake_run)
    out = tmp_path / "lines.jsonl"
    rec = validate_curricula.run_one("PushKalmanFilter", out=str(out), device="cpu",
                                     synth_traj=4, synth_t=50, timeout=60,
                                     workdir=str(tmp_path))
    (train, env, cwd, timeout), (evaluate, *_) = calls
    assert train[1:] == ["-u", "-m", "multimodalfilter_tpu_torch.scripts.push_task.train_push",
                         "--model-type", "PushKalmanFilter", "--experiment-name",
                         "validate_PushKalmanFilter", "--device", "cpu"]
    assert evaluate[1:] == ["-u", "-m", "multimodalfilter_tpu_torch.scripts.push_task.eval_push",
                            "--experiment-name", "validate_PushKalmanFilter", "--device",
                            "cpu", "--save"]
    assert cwd == str(tmp_path) and 0 < timeout <= 60
    assert (env["MMF_TPU_SYNTHESIZE_DATA"], env["MMF_TPU_SYNTH_TRAJ"],
            env["MMF_TPU_SYNTH_T"], env["MMF_TPU_OFFLINE"]) == ("1", "4", "50", "1")
    assert env["PYTHONPATH"].split(os.pathsep)[0] == REPO
    assert rec["ok"] and rec["rmse"] == {"x_rmse_cm_mean": 1.5}
    calls.clear()
    rec = validate_curricula.run_one("DoorLSTMFilter", out=str(out), device="cpu",
                                     workdir=str(tmp_path))
    assert calls[0][0][3] == "multimodalfilter_tpu_torch.scripts.door_task.train_door"
    rec = validate_curricula.run_one("PushLSTMFilter", out=str(out), device="cpu",
                                     workdir=str(tmp_path))
    assert not rec["ok"] and rec["train_tail"] == "outboom" and "eval_s" not in rec
    lines = [json.loads(line) for line in out.read_text().splitlines()]
    assert [r["model"] for r in lines] == ["PushKalmanFilter", "DoorLSTMFilter",
                                           "PushLSTMFilter"]


@pytest.fixture(scope="module")
def cli_bundle(tmp_path_factory):
    """scripts/export_serving.py on a checkpointed DoorParticleFilter (T=1,
    N=2, the default M), with --verify asserting the bitwise replay
    in-process. Returns the bundle's path."""
    work = tmp_path_factory.mktemp("export_cli")
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(work)  # Buddy's directories are cwd-relative
        for name in ("MMF_TPU_SERVING", "MMF_TPU_FUSED_STEP", "MMF_TPU_RBG"):
            mp.delenv(name, raising=False)
        buddy = Buddy("export_cli_test", verbose=False)
        buddy.attach_model(tdoor.DoorParticleFilter(device="cpu"))
        buddy.set_metadata({"model_type": "DoorParticleFilter", "dataset_args": {}})
        buddy.save_checkpoint(label="final")
        return export_serving.main([
            "--experiment-name", "export_cli_test", "--checkpoint-label", "final",
            "--task", "door", "--batch", "2", "--timesteps", "1",
            "--output", str(work / "bundle"), "--device", "cpu", "--verify"])


def test_export_cli_roundtrip(cli_bundle):
    assert sorted(os.listdir(cli_bundle)) == ["init.pt2", "loop.pt2", "meta.json", "params.pt"]
    with open(os.path.join(cli_bundle, "meta.json")) as f:
        meta = json.load(f)
    assert meta["definition"] == "ParticleFilterDef" and meta["controls_spec"][0] == [1, 2, 7]


def test_bundle_loads_without_model_code(cli_bundle, tmp_path):
    """A bundle runs in a process that imports no model code: afterwards
    its sys.modules holds none of the port's crossmodal, filtering or
    models, and its estimates equal this process's load of the bundle."""
    rng = np.random.default_rng(8)
    obs = {"image": rng.normal(size=(1, 2, 32, 32)), "gripper_pos": rng.normal(size=(1, 2, 3)),
           "gripper_sensors": rng.normal(size=(1, 2, 7))}
    ctrl = rng.normal(size=(1, 2, 7))
    mean, cov = np.zeros((2, 3)), np.tile(0.1 * np.eye(3), (2, 1, 1))
    np.savez(tmp_path / "inputs.npz", mean=mean, cov=cov, ctrl=ctrl, **obs)
    script = f"""
import sys
import numpy as np
import torch
from multimodalfilter_tpu_torch.experiments.export import load_serving_bundle
torch.set_num_threads(1)
x = np.load({str(tmp_path / 'inputs.npz')!r})
served = load_serving_bundle({cli_bundle!r}, seed=0)
served.initialize_beliefs(mean=x["mean"], covariance=x["cov"])
obs = {{k: x[k] for k in ("image", "gripper_pos", "gripper_sensors")}}
np.save({str(tmp_path / 'estimates.npy')!r},
        served.forward_loop(observations=obs, controls=x["ctrl"]).numpy())
print(sorted(m for m in sys.modules if m.startswith("multimodalfilter_tpu_torch.")))
"""
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO, capture_output=True,
                          text=True, timeout=120, env={**os.environ, "PYTHONPATH": REPO})
    assert proc.returncode == 0, proc.stderr[-3000:]
    loaded = eval(proc.stdout.strip().splitlines()[-1])
    for part in ("crossmodal", "filtering", "models"):
        assert not [m for m in loaded if m.startswith(f"multimodalfilter_tpu_torch.{part}")]
    served = load_serving_bundle(cli_bundle, seed=0)
    served.initialize_beliefs(mean=mean, covariance=cov)
    want = served.forward_loop(observations=obs, controls=ctrl).numpy()
    np.testing.assert_array_equal(np.load(tmp_path / "estimates.npy"), want)


class MockDoorEnv:
    """The scripted stand-in for robosuite's PandaDoor of
    tests/test_data_collection.py (a copy): first-order EEF kinematics under
    a saturating position controller, a door hinge that moves at a set
    rate, and the reference env's observation keys."""

    MAX_STEP = 0.05
    CONTROL_FREQ = 20.0

    def __init__(self, hinge_rate=0.0, contact=True, q_limits=False):
        self.hinge_rate = hinge_rate
        self.contact = contact
        self.q_limits_active = q_limits
        self.door_hinge_angle = 0.0
        self.hand_pos = np.array([0.45, 0.0, 1.5])
        self.hand_velocity = np.zeros(3)
        self.joint_positions = None
        self.rng = np.random.default_rng(0)

    def reset(self):
        self.hand_pos = np.array([0.45, 0.0, 1.5])
        self.hand_velocity = np.zeros(3)
        self.door_hinge_angle = 0.0
        return self._obs()

    def set_robot_joint_positions(self, joints):
        self.joint_positions = np.asarray(joints)

    def _check_q_limits(self):
        return self.q_limits_active

    def step(self, action):
        delta = np.clip(np.asarray(action, dtype=float)[:3], -self.MAX_STEP, self.MAX_STEP)
        self.hand_pos = self.hand_pos + delta
        self.hand_velocity = delta * self.CONTROL_FREQ
        self.door_hinge_angle += self.hinge_rate
        return self._obs(), 0.0, False, {}

    def _obs(self):
        return {
            "object-state": np.array([float(self.contact), self.door_hinge_angle, 0.0, 0.01,
                                      -0.02]),
            "eef_pos": self.hand_pos.copy(),
            "ee-force-obs": self.rng.normal(0, 1.0, 3),
            "ee-torque-obs": self.rng.normal(0, 0.1, 3),
            "contact-obs": bool(self.contact),
            "image": self.rng.integers(0, 255, (64, 64, 3), dtype=np.uint8),
        }


def _read(path, file_cls):
    with file_cls(str(path)) as f:
        return [f[i] for i in range(len(f))]


@pytest.mark.parametrize("policy,env_kwargs,steps", [
    ("pull", dict(hinge_rate=0.01), 35), ("push", dict(hinge_rate=-0.05), 40),
    ("pull", dict(q_limits=True), 420), ("pull", dict(contact=False), 30)])
def test_run_episode_matches_jax(tmp_path, policy, env_kwargs, steps):
    """run_episode on the mock env, the same seeds on both sides: the same
    termination cause and the same trajectories written, bitwise."""
    causes, files = [], []
    for pkg, sim, file_cls in ((waypoint_policies, simulate_door, TrajectoriesFile),
                               (jax_waypoint_policies, jax_simulate_door,
                                JaxTrajectoriesFile)):
        cls = pkg.PullWaypointPolicy if policy == "pull" else pkg.PushWaypointPolicy
        path = tmp_path / f"{sim.__name__.replace('.', '_')}.hdf5"
        with file_cls(str(path), "a") as f:
            causes.append(sim.run_episode(MockDoorEnv(**env_kwargs),
                                          cls(rng=np.random.default_rng(4)), f,
                                          max_iterations=steps))
        files.append(_read(path, file_cls))
    assert causes[0] == causes[1]
    assert len(files[0]) == len(files[1]) == (0 if causes[0] == "joint limits" else 1)
    for got, want in zip(*files):
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])


def test_simulate_door_synthetic_and_robosuite(tmp_path, monkeypatch):
    """--synthetic writes what the JAX package's synthesiser writes; the
    simulation without robosuite raises, naming it."""
    monkeypatch.setenv("MMF_TPU_SYNTH_T", "20")
    simulate_door.main(["--output", str(tmp_path / "port.hdf5"), "--synthetic",
                        "--num-trajectories", "2", "--seed", "3"])
    from multimodalfilter_tpu.data import synthetic as jsynthetic

    jsynthetic._synthesize_door(str(tmp_path / "jax.hdf5"), 2, 3)
    got = _read(tmp_path / "port.hdf5", TrajectoriesFile)
    want = _read(tmp_path / "jax.hdf5", JaxTrajectoriesFile)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.keys() == w.keys() and all(np.array_equal(g[k], w[k]) for k in w)
    monkeypatch.setitem(sys.modules, "robosuite", None)
    with pytest.raises(ImportError, match="robosuite"):
        simulate_door.main(["--output", str(tmp_path / "sim.hdf5")])
