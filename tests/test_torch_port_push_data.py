"""The port's push data against the JAX package on the CPU: the push loader
(train and eval sets, MuJoCo and ``--kloss_dataset``, bit for bit, clean,
with a seeded blackout, and without positions and sensors at a sequential
rate of 3), the push synthesiser against the JAX writer, and the in-memory
path that runs where ``h5py`` is missing.

Both packages read the same small synthetic files (T = 40 to 49, two
trajectories a file but for ``kloss_train0``, whose name caps it at one),
written once under a temporary directory that both cache paths point at;
the repo's ``.cache/`` is never touched.
"""

import os
import sys

import numpy as np
import pytest

import multimodalfilter_tpu.data.cache as jcache
import multimodalfilter_tpu.data.synthetic as jsynthetic
from crossmodal.tasks import _push as jpush_task
from multimodalfilter_tpu.data.trajectories_file import TrajectoriesFile as JaxTrajectoriesFile
from multimodalfilter_tpu_torch.crossmodal.tasks import _push as tpush_task
from multimodalfilter_tpu_torch.data import cache, synthetic

MUJOCO_FILES = ("gentle_push_10.hdf5", "gentle_push_1000.hdf5")
KLOSS_FILES = tuple(f"kloss_train{i}.hdf5" for i in range(6)) + ("kloss_val.hdf5",)
SEEDS = {name: 20 + i for i, name in enumerate(MUJOCO_FILES + KLOSS_FILES)}
CLEAN = dict(use_vision=True, use_proprioception=True, use_haptics=True,
             image_blackout_ratio=0.0, sequential_image_rate=1)


def _small_synthesis(monkeypatch):
    monkeypatch.setenv("MMF_TPU_SYNTH_T", "40")
    monkeypatch.setenv("MMF_TPU_SYNTH_TRAJ", "2")


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    """The push files, each from its own explicit seed."""
    path = tmp_path_factory.mktemp("push_cache")
    with pytest.MonkeyPatch.context() as mp:
        _small_synthesis(mp)
        for name, seed in SEEDS.items():
            synthetic.synthesize_named_dataset(name, str(path / name), seed=seed)
    return path


@pytest.fixture()
def both_caches(data_dir, monkeypatch):
    """Both packages' cache paths at the shared files; no download."""
    monkeypatch.setenv("MMF_TPU_OFFLINE", "1")
    monkeypatch.delenv("MMF_TPU_SYNTHESIZE_DATA", raising=False)
    monkeypatch.setattr(jcache, "_cache_path", str(data_dir))
    monkeypatch.setattr(cache, "_cache_path", str(data_dir))
    monkeypatch.setattr(cache, "_in_memory", {})
    return data_dir


def _assert_trajectories_equal(a, b):
    assert len(a) == len(b) > 0
    for (sa, oa, ca), (sb, ob, cb) in zip(a, b):
        assert sa.shape[1] == 2
        np.testing.assert_array_equal(sa, sb)
        np.testing.assert_array_equal(ca, cb)
        assert oa.keys() == ob.keys()
        for k in oa:
            assert oa[k].dtype == ob[k].dtype == np.float32
            np.testing.assert_array_equal(oa[k], ob[k])


@pytest.mark.parametrize("kloss", [False, True], ids=["mujoco", "kloss"])
@pytest.mark.parametrize("split", ["eval", "train"])
@pytest.mark.parametrize("args", [
    pytest.param(CLEAN, id="clean"),
    pytest.param(dict(CLEAN, image_blackout_ratio=0.3, seed=5), id="blackout0.3"),
    pytest.param(dict(CLEAN, use_proprioception=False, use_haptics=False,
                      sequential_image_rate=3), id="no-pos-sensors-rate3"),
])
def test_push_loader_matches_jax_bitwise(both_caches, split, kloss, args):
    method = f"get_{split}_trajectories"
    args = dict(args, kloss_dataset=kloss)
    jax_trajs = getattr(jpush_task.PushTask, method)(**args)
    port_trajs = getattr(tpush_task.PushTask, method)(**args)
    _assert_trajectories_equal(jax_trajs, port_trajs)
    # Train: every file (kloss: 1 + 1 + 4 x 2 trajectories); eval: one.
    assert len(port_trajs) == {("train", False): 2, ("train", True): 10,
                               ("eval", False): 2, ("eval", True): 2}[split, kloss]
    if args["image_blackout_ratio"]:
        frames = np.concatenate([o["image"] for _, o, _ in port_trajs])
        assert 0 < (np.abs(frames).sum(axis=(1, 2)) == 0).mean() < 1


def test_kloss_eval_split_caps_at_fifty(both_caches, monkeypatch):
    """The eval split takes at most the first 50 kloss_val trajectories, as
    the JAX loader's ("kloss_val.hdf5", 50) does."""
    calls = []
    real = tpush_task._load_trajectories

    def recording(*files, **kwargs):
        calls.append(files)
        return real(*files, **kwargs)

    monkeypatch.setattr(tpush_task, "_load_trajectories", recording)
    tpush_task.PushTask.get_eval_trajectories(**CLEAN, kloss_dataset=True)
    assert calls == [(("kloss_val.hdf5", 50),)]
    assert tpush_task.dataset_urls == jpush_task.dataset_urls
    assert tpush_task.NORMALIZATION == jpush_task.NORMALIZATION


@pytest.mark.parametrize("kloss", [False, True], ids=["mujoco", "kloss"])
def test_push_generator_matches_jax_writer(tmp_path, monkeypatch, kloss):
    """The port's push generator, through its HDF5 writer and in memory,
    against the JAX package's writer at the same seed."""
    _small_synthesis(monkeypatch)
    jsynthetic._synthesize_push(str(tmp_path / "jax.hdf5"), 2, 7, kloss)
    synthetic._synthesize_push(str(tmp_path / "port.hdf5"), 2, 7, kloss)
    in_memory = list(synthetic.push_trajectories(2, 7, kloss))
    with JaxTrajectoriesFile(str(tmp_path / "jax.hdf5")) as fj, \
            JaxTrajectoriesFile(str(tmp_path / "port.hdf5")) as fp:
        jax_raw, port_raw = list(fj), list(fp)
    assert len(jax_raw) == len(port_raw) == len(in_memory) == 2
    for a, b, c in zip(jax_raw, port_raw, in_memory):
        assert a.keys() == b.keys() == c.keys()
        assert ("pos" in a) == kloss
        for k in a:
            assert a[k].dtype == b[k].dtype == c[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
            np.testing.assert_array_equal(a[k], c[k])


@pytest.mark.parametrize("kloss", [False, True], ids=["mujoco", "kloss"])
def test_in_memory_push_set_without_h5py_matches_files(tmp_path, monkeypatch, kloss):
    """Where h5py is missing and MMF_TPU_SYNTHESIZE_DATA=1, the push loader
    synthesises in memory, writes no file, and loads what the HDF5 path
    loads (same process, so the same name-hash seeds)."""
    _small_synthesis(monkeypatch)
    monkeypatch.setenv("MMF_TPU_OFFLINE", "1")
    monkeypatch.setattr(cache, "_in_memory", {})
    files = tmp_path / "files"
    for name in ("kloss_val.hdf5",) if kloss else ("gentle_push_10.hdf5",):
        synthetic.synthesize_named_dataset(name, str(files / name))
    monkeypatch.setattr(cache, "_cache_path", str(files))
    args = dict(CLEAN, kloss_dataset=kloss)
    from_files = tpush_task.PushTask.get_eval_trajectories(**args)

    monkeypatch.setitem(sys.modules, "h5py", None)
    monkeypatch.setenv("MMF_TPU_SYNTHESIZE_DATA", "1")
    empty = tmp_path / "empty"
    cache.set_cache_path(str(empty))
    in_memory = tpush_task.PushTask.get_eval_trajectories(**args)
    _assert_trajectories_equal(from_files, in_memory)
    assert os.listdir(empty) == []
