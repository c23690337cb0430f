"""The port's data layer against the JAX package on the CPU: the door loader
(train and eval sets, bit for bit, clean and with a seeded blackout), the
synthetic generator against the JAX writer, the in-memory path that runs
where ``h5py`` is missing, and the mask, control and blackout helpers.

Both packages read the same small synthetic files (T = 40 to 49, two
trajectories a file), written once under a temporary directory that both
cache paths point at; the repo's ``.cache/`` is never touched.
"""

import os
import sys

import numpy as np
import pytest
import torch

import multimodalfilter_tpu.data.cache as jcache
import multimodalfilter_tpu.data.synthetic as jsynthetic
from crossmodal.tasks import _door as jdoor_task
from multimodalfilter_tpu.data.augment import apply_sequential_rate as jax_sequential_rate
from multimodalfilter_tpu.data.trajectories_file import TrajectoriesFile as JaxTrajectoriesFile
from multimodalfilter_tpu_torch.crossmodal.tasks import _door as tdoor_task
from multimodalfilter_tpu_torch.data import augment, cache, synthetic

EVAL_FILES = ("panda_door_pull_10.hdf5", "panda_door_push_10.hdf5")
TRAIN_FILES = ("panda_door_pull_100.hdf5", "panda_door_push_100.hdf5")
SEEDS = {name: i for i, name in enumerate(EVAL_FILES + TRAIN_FILES)}
CLEAN = dict(use_vision=True, use_proprioception=True, use_haptics=True,
             image_blackout_ratio=0.0, sequential_image_rate=1)


def _small_synthesis(monkeypatch):
    monkeypatch.setenv("MMF_TPU_SYNTH_T", "40")
    monkeypatch.setenv("MMF_TPU_SYNTH_TRAJ", "2")


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    """The four door files, each from its own explicit seed."""
    path = tmp_path_factory.mktemp("door_cache")
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
        np.testing.assert_array_equal(sa, sb)
        np.testing.assert_array_equal(ca, cb)
        assert oa.keys() == ob.keys()
        for k in oa:
            assert oa[k].dtype == ob[k].dtype == np.float32
            np.testing.assert_array_equal(oa[k], ob[k])


@pytest.mark.parametrize("split", ["eval", "train"])
@pytest.mark.parametrize("args", [
    pytest.param(CLEAN, id="clean"),
    pytest.param(dict(CLEAN, image_blackout_ratio=0.3, seed=5), id="blackout0.3"),
    pytest.param(dict(CLEAN, use_proprioception=False, use_haptics=False,
                      sequential_image_rate=3), id="no-pos-sensors-rate3"),
])
def test_door_loader_matches_jax_bitwise(both_caches, split, args):
    method = f"get_{split}_trajectories"
    jax_trajs = getattr(jdoor_task.DoorTask, method)(**args)
    port_trajs = getattr(tdoor_task.DoorTask, method)(**args)
    _assert_trajectories_equal(jax_trajs, port_trajs)
    if args["image_blackout_ratio"]:
        frames = np.concatenate([o["image"] for _, o, _ in port_trajs])
        assert 0 < (np.abs(frames).sum(axis=(1, 2)) == 0).mean() < 1


def test_generator_matches_jax_writer(tmp_path, monkeypatch):
    """The port's raw-trajectory generator, through its HDF5 writer and in
    memory, against the JAX package's writer at the same seed."""
    _small_synthesis(monkeypatch)
    jsynthetic._synthesize_door(str(tmp_path / "jax.hdf5"), 2, 7)
    synthetic._synthesize_door(str(tmp_path / "port.hdf5"), 2, 7)
    in_memory = list(synthetic.door_trajectories(2, 7))
    with JaxTrajectoriesFile(str(tmp_path / "jax.hdf5")) as fj, \
            JaxTrajectoriesFile(str(tmp_path / "port.hdf5")) as fp:
        jax_raw, port_raw = list(fj), list(fp)
    assert len(jax_raw) == len(port_raw) == len(in_memory) == 2
    for a, b, c in zip(jax_raw, port_raw, in_memory):
        assert a.keys() == b.keys() == c.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype == c[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
            np.testing.assert_array_equal(a[k], c[k])


def test_in_memory_eval_set_without_h5py_matches_files(tmp_path, monkeypatch):
    """Where h5py is missing and MMF_TPU_SYNTHESIZE_DATA=1, the loader
    synthesises in memory, writes no file, and loads what the HDF5 path
    loads (same process, so the same name-hash seeds)."""
    _small_synthesis(monkeypatch)
    monkeypatch.setenv("MMF_TPU_OFFLINE", "1")
    monkeypatch.setattr(cache, "_in_memory", {})
    files = tmp_path / "files"
    for name in EVAL_FILES:
        synthetic.synthesize_named_dataset(name, str(files / name))
    monkeypatch.setattr(cache, "_cache_path", str(files))
    from_files = tdoor_task.DoorTask.get_eval_trajectories(**CLEAN)

    monkeypatch.setitem(sys.modules, "h5py", None)
    monkeypatch.setenv("MMF_TPU_SYNTHESIZE_DATA", "1")
    empty = tmp_path / "empty"
    cache.set_cache_path(str(empty))
    in_memory = tdoor_task.DoorTask.get_eval_trajectories(**CLEAN)
    _assert_trajectories_equal(from_files, in_memory)
    assert os.listdir(empty) == []
    # Each load reads the held set afresh: a load without proprioception
    # zeroes its positions in place, and the next load is clean again.
    tdoor_task.DoorTask.get_eval_trajectories(**dict(CLEAN, use_proprioception=False))
    again = tdoor_task.DoorTask.get_eval_trajectories(**CLEAN)
    _assert_trajectories_equal(in_memory, again)


@pytest.mark.parametrize("cached", [False, True], ids=["no-file", "file-cached"])
def test_without_h5py_the_loader_raises(both_caches, tmp_path, monkeypatch, cached):
    """No h5py and no in-memory data possible: ImportError naming h5py and
    the flag. With the flag off and no file; or with a cached file, which
    is never replaced by data of another kind, flag or not."""
    monkeypatch.setitem(sys.modules, "h5py", None)
    if cached:
        monkeypatch.setenv("MMF_TPU_SYNTHESIZE_DATA", "1")
    else:
        cache.set_cache_path(str(tmp_path / "empty"))
    with pytest.raises(ImportError, match="h5py.*MMF_TPU_SYNTHESIZE_DATA"):
        tdoor_task.DoorTask.get_eval_trajectories(**CLEAN)


def test_push_synthesis_names_its_roadmap_item(tmp_path):
    with pytest.raises(NotImplementedError, match="A11"):
        synthetic.synthesize_named_dataset("gentle_push_10.hdf5", str(tmp_path / "p"))


@pytest.mark.parametrize("kwargs", [
    pytest.param(dict(use_vision=False, image_blackout_ratio=0.0,
                      sequential_image_rate=1), id="no-vision"),
    pytest.param(dict(use_vision=True, image_blackout_ratio=0.0,
                      sequential_image_rate=3), id="rate3"),
    pytest.param(dict(use_vision=True, image_blackout_ratio=0.3,
                      sequential_image_rate=1), id="blackout0.3"),
])
def test_make_image_mask_and_controls_match_jax(kwargs):
    t = 50
    a = jdoor_task.make_image_mask(t, rng=np.random.default_rng(3), **kwargs)
    b = tdoor_task.make_image_mask(t, rng=np.random.default_rng(3), **kwargs)
    assert a.dtype == b.dtype == np.float32
    np.testing.assert_array_equal(a, b)

    r = np.random.default_rng(4)
    eef = r.normal(size=(t, 3)).astype(np.float32)
    contact = (r.uniform(size=t) > 0.5).astype(np.float32)
    np.testing.assert_array_equal(jdoor_task.make_controls(eef.copy(), contact),
                                  tdoor_task.make_controls(eef.copy(), contact))


def test_apply_image_blackout_rate():
    """i.i.d. Bernoulli(1 - ratio) per frame, broadcast over pixels: the
    zeroed fraction of 20,000 frames lies within 4 sigma of the ratio."""
    ratio, frames = 0.3, 20_000
    images = torch.ones((frames // 4, 4, 8, 8))
    g = torch.Generator().manual_seed(0)
    out = augment.apply_image_blackout(g, images, ratio)
    per_frame = out.reshape(frames, -1)
    zeroed = per_frame.amax(dim=1) == 0
    assert bool(((per_frame == 0).all(dim=1) | (per_frame == 1).all(dim=1)).all())
    sigma = (ratio * (1 - ratio) / frames) ** 0.5
    assert abs(float(zeroed.float().mean()) - ratio) < 4 * sigma
    again = augment.apply_image_blackout(torch.Generator().manual_seed(0), images, ratio)
    assert torch.equal(out, again)


def test_apply_sequential_rate_matches_jax():
    images = np.random.default_rng(0).normal(size=(7, 3, 4, 4)).astype(np.float32)
    for axis in (0, 1):
        np.testing.assert_array_equal(
            np.asarray(jax_sequential_rate(images, 3, axis=axis)),
            augment.apply_sequential_rate(torch.from_numpy(images), 3, axis=axis).numpy(),
        )
