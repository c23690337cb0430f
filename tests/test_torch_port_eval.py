"""The port's door eval pipeline against the JAX package on the CPU:
``get_eval_batch``, the metric math, ``run_eval`` in both modes,
``run_eval_stats`` sequential and batched, the model registry and the eval
CLI.

Both packages read the same small synthetic eval set (two trajectories a
file, so N = 4; T = 40 to 49, truncated to the shortest) and run the same
weights (the JAX model's, copied through ``weights``) at full width (units
64) with M = 300 eval particles. The chained throughput timer is off on both
sides (MMF_TPU_EVAL_DEVICE_THROUGHPUT=0): it changes no RMSE.

``run_eval`` draws its noise and uniforms from each package's own stream,
so the filter comparison replays the JAX run's draws in the port: the JAX
facade's keys are recorded, the timed loop's key is split as JAX's
``forward_loop`` splits it, and the port gets the arrays through
``eps_seq``/``uniforms_seq`` and the JAX initial belief through the belief
setter.
"""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

import crossmodal._eval_batching as jbatching
import crossmodal._eval_metrics as jmetrics
import crossmodal._eval_state as jstate
import crossmodal.eval_helpers as jeval
import multimodalfilter_tpu.data.cache as jcache
from crossmodal import door_models as jdoor
from crossmodal.tasks import DoorTask as JaxDoorTask
from multimodalfilter_tpu.experiments import Buddy as JaxBuddy
from multimodalfilter_tpu_torch.crossmodal import _eval_batching as tbatching
from multimodalfilter_tpu_torch.crossmodal import _eval_metrics as tmetrics
from multimodalfilter_tpu_torch.crossmodal import _eval_state as tstate
from multimodalfilter_tpu_torch.crossmodal import door_models as tdoor
from multimodalfilter_tpu_torch.crossmodal import eval_helpers as teval
from multimodalfilter_tpu_torch.crossmodal.tasks import DoorTask
from multimodalfilter_tpu_torch.data import augment, cache, synthetic
from multimodalfilter_tpu_torch.experiments import Buddy
from multimodalfilter_tpu_torch.filtering import pf as tpf
from multimodalfilter_tpu_torch.ops import pf_kernels
from multimodalfilter_tpu_torch.scripts.door_task import eval_door
from multimodalfilter_tpu_torch.types import ParticleBelief

EVAL_FILES = ("panda_door_pull_10.hdf5", "panda_door_push_10.hdf5")
DATASET_ARGS = dict(use_vision=True, use_proprioception=True, use_haptics=True,
                    image_blackout_ratio=0.0, sequential_image_rate=1)
M = 300
TIE = 1e-6  # fp32 CDFs summed in different orders differ by ~1e-7
# Per-step estimates after up to 39 steps: fp32 nets (convs, 64-wide trunks)
# in two frameworks, reassociated sums compounding over the recursion.
LOOP_ATOL = 1e-4
# The raw RMSE is a root mean square over the same (step, trajectory) grid,
# so by the triangle inequality two runs' RMSEs differ by at most their
# largest per-step gap: LOOP_ATOL bounds it.
RMSE_ATOL = LOOP_ATOL
STAT_KEYS = {f"{k}_{s}" for k in ("theta_rmse_deg", "x_rmse_cm", "y_rmse_cm",
                                   "filter_steps_per_sec", "filter_steps_per_sec_e2e")
             for s in ("mean", "std")}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's per-step loop at N = 4 runs ~90 small ops a step. On one
    thread each, a machine busy with other test workers does not stall
    every op on an oversubscribed thread pool. Restored after the module."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    path = tmp_path_factory.mktemp("door_eval_cache")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MMF_TPU_SYNTH_T", "40")
        mp.setenv("MMF_TPU_SYNTH_TRAJ", "2")
        for seed, name in enumerate(EVAL_FILES):
            synthetic.synthesize_named_dataset(name, str(path / name), seed=seed)
    return path


@pytest.fixture(scope="module")
def models():
    """The JAX model (seed 0) and the port's with its weights."""
    jm = jdoor.DoorCrossmodalParticleFilter()
    tm = tdoor.DoorCrossmodalParticleFilter(device="cpu")
    tm.load_jax_params(jm.params)
    return jm, tm


@pytest.fixture()
def configured(data_dir, models, tmp_path, monkeypatch):
    """Both eval modules configured on the shared files."""
    monkeypatch.setenv("MMF_TPU_OFFLINE", "1")
    monkeypatch.setenv("MMF_TPU_EVAL_DEVICE_THROUGHPUT", "0")
    monkeypatch.delenv("MMF_TPU_EVAL_BATCH_REPEATS", raising=False)
    monkeypatch.setattr(jcache, "_cache_path", str(data_dir))
    monkeypatch.setattr(cache, "_cache_path", str(data_dir))
    jm, tm = models
    jbuddy = JaxBuddy("eval", jm, checkpoint_dir=str(tmp_path / "jc"),
                      metadata_dir=str(tmp_path / "jm"), log_dir=str(tmp_path / "jl"),
                      verbose=False)
    tbuddy = Buddy("eval", tm, log_dir=str(tmp_path / "tl"), verbose=False)
    jeval.configure(buddy=jbuddy, task=JaxDoorTask, dataset_args=dict(DATASET_ARGS))
    teval.configure(buddy=tbuddy, task=DoorTask, dataset_args=dict(DATASET_ARGS))
    return jm, tm


def test_registry_holds_the_four_door_pfs():
    assert sorted(DoorTask.model_types) == [
        "DoorCrossmodalParticleFilter", "DoorCrossmodalParticleFilterSeq5",
        "DoorParticleFilter", "DoorUnimodalParticleFilter"]
    for name, cls in DoorTask.model_types.items():
        assert cls is getattr(tdoor, name)
        assert cls.__name__ in JaxDoorTask.model_types


@pytest.mark.parametrize("tile", [1, 2])
def test_get_eval_batch_matches_jax(configured, tile):
    js, jo, jc = jbatching.get_eval_batch(tile=tile)
    ts, to, tc = tbatching.get_eval_batch(tile=tile)
    assert ts.shape[:2] == (js.shape[0], 4 * tile) and ts.shape[0] >= 40
    np.testing.assert_array_equal(js, ts)
    np.testing.assert_array_equal(np.asarray(jc), tc.numpy())
    assert jo.keys() == to.keys()
    for k in jo:
        assert to[k].dtype == torch.float32
        np.testing.assert_array_equal(np.asarray(jo[k]), to[k].numpy())
    # Cached: the same device tensors on the next call.
    assert tbatching.get_eval_batch(tile=tile)[2] is tc


def test_get_eval_batch_blackout_remasks_from_the_repeat_stream(configured, monkeypatch):
    """Each call re-masks the cached images on the device with a generator
    seeded by S.rng.integers(2**31), as JAX seeds its key."""
    _, clean, _ = tbatching.get_eval_batch()
    tstate.dataset_args["image_blackout_ratio"] = 0.3
    monkeypatch.setattr(tstate, "rng", np.random.default_rng(11))
    _, first, _ = tbatching.get_eval_batch()
    _, second, _ = tbatching.get_eval_batch()
    seeds = np.random.default_rng(11).integers(2**31, size=2)
    for seed, obs in zip(seeds, (first, second)):
        expected = augment.apply_image_blackout(
            torch.Generator().manual_seed(int(seed)), clean["image"], 0.3)
        assert torch.equal(obs["image"], expected)
    assert not torch.equal(first["image"], second["image"])
    assert torch.equal(first["gripper_pos"], clean["gripper_pos"])


@pytest.mark.parametrize("t", [10, 31, 32, 200])
def test_metric_math_matches_jax(t, monkeypatch):
    monkeypatch.setattr(jstate, "task", JaxDoorTask)
    monkeypatch.setattr(tstate, "task", DoorTask)
    assert tmetrics.burn_in_truncation(t) == jmetrics.burn_in_truncation(t)
    raw = np.random.default_rng(t).uniform(size=3)
    assert (tmetrics.metric_results(raw, 1.0, 2.0, verbose=False)
            == jmetrics.metric_results(raw, 1.0, 2.0, verbose=False))


def test_metric_math_refuses_the_push_task(monkeypatch):
    monkeypatch.setattr(tstate, "task", type("PushTask", (), {}))
    with pytest.raises(NotImplementedError, match="A11"):
        tmetrics.metric_results(np.ones(2), 1.0, 1.0)


def test_run_eval_dynamics_matches_jax(configured):
    """The noise-free dynamics rollout is deterministic; the two fp32
    dynamics trunks round differently, compounding over 39 steps: the raw
    RMSEs (O(1-10)) agree within 1e-5 of their scale."""
    jr = jeval.run_eval(eval_dynamics=True)
    tr = teval.run_eval(eval_dynamics=True)
    assert tr.keys() == jr.keys()
    scale = max(1.0, float(np.max(jr["raw_rmse"])))
    np.testing.assert_allclose(tr["raw_rmse"], jr["raw_rmse"], atol=1e-5 * scale, rtol=0)
    assert np.isfinite(tr["raw_rmse"]).all()


def _jax_loop_draws(key, t, n, m, d):
    """JAX forward_loop's pre-draw: split into T keys, split each, normal
    (N*M, D) and uniform (N, M)."""
    pairs = jax.vmap(jax.random.split)(jax.random.split(key, t))
    eps = jax.vmap(lambda k: jax.random.normal(k, (n * m, d)))(pairs[:, 0])
    uni = jax.vmap(lambda k: jax.random.uniform(k, (n, m)))(pairs[:, 1])
    return torch.from_numpy(np.array(eps)), torch.from_numpy(np.array(uni))


@pytest.mark.parametrize("m,key_seed", [
    # Every draw off a tie, so the whole run is compared, and its RMSE. At
    # M = 300 a run makes 46,800 draws and ~30 of them land within TIE of a
    # CDF entry, so no seed is free of ties there; at M = 32, ~0.3 do.
    pytest.param(32, 1, id="M32-no-tie"),
    # The eval's M: each trajectory compared through the step of its first
    # tie (the estimate is taken before that step's resampling).
    pytest.param(M, 0, id="M300-through-first-tie"),
])
def test_run_eval_with_replayed_draws_matches_jax(configured, monkeypatch, m, key_seed):
    jm, tm = configured
    monkeypatch.setattr(jm, "_rng", jax.random.PRNGKey(key_seed))
    monkeypatch.setattr(jm, "_fn_cache", {})  # JAX's warm-up runs as on a first call
    for model in (jm, tm):
        monkeypatch.setattr(model, "definition",
                            dataclasses.replace(model.definition, num_particles_eval=m))
    keys, beliefs, jax_est = [], [], []
    next_key, init, loop = jm._next_key, jm.initialize_beliefs, jm.forward_loop

    def recording_key():
        keys.append(next_key())
        return keys[-1]

    def recording_init(**kwargs):
        init(**kwargs)
        beliefs.append(jm.belief)

    def recording_loop(**kwargs):
        jax_est.append(np.asarray(loop(**kwargs)))
        return jax_est[-1]

    monkeypatch.setattr(jm, "_next_key", recording_key)
    monkeypatch.setattr(jm, "initialize_beliefs", recording_init)
    monkeypatch.setattr(jm, "forward_loop", recording_loop)
    jr = jeval.run_eval()

    t1, n = jax_est[-1].shape[:2]
    eps, uni = _jax_loop_draws(keys[-1], t1, n, m, 3)
    belief0 = ParticleBelief(*(torch.from_numpy(np.array(x)) for x in beliefs[-1]))
    port_est, gaps = [], []
    tloop = tm.forward_loop
    real_tail = tpf.pf_update_and_resample

    def recording_tail(log_weights, log_liks, particles, uniforms, **kwargs):
        _, cdf = pf_kernels.resample_cdf(log_weights, log_liks)
        gaps.append(pf_kernels.tie_gaps(cdf, uniforms).amin(dim=1))
        return real_tail(log_weights, log_liks, particles, uniforms, **kwargs)

    def replaying_loop(**kwargs):
        gaps.clear()  # the last loop run is the timed one
        port_est.append(tloop(**kwargs, eps_seq=eps, uniforms_seq=uni))
        return port_est[-1]

    monkeypatch.setattr(tpf, "pf_update_and_resample", recording_tail)
    monkeypatch.setattr(tm, "initialize_beliefs",
                        lambda **kwargs: setattr(tm, "belief", belief0))
    monkeypatch.setattr(tm, "forward_loop", replaying_loop)
    tr = teval.run_eval()

    est = port_est[-1].numpy()
    assert np.isfinite(est).all() and est.shape == (t1, n, 3) and len(gaps) == t1
    tie = (torch.stack(gaps) <= TIE).numpy()  # (T-1, N)
    first_tie = np.where(tie.any(axis=0), tie.argmax(axis=0), t1)
    compared = np.arange(t1)[:, None] <= first_tie[None, :]
    np.testing.assert_allclose(est[compared], jax_est[-1][compared], atol=LOOP_ATOL, rtol=0)
    assert tr.keys() == jr.keys()
    if m == M:
        assert compared.sum() >= 2 * n, first_tie
        return
    assert not tie.any(), first_tie  # the seed has no tie
    np.testing.assert_allclose(tr["raw_rmse"], jr["raw_rmse"], atol=RMSE_ATOL, rtol=0)


def _jax_stat_keys():
    """The keys JAX's run_eval_stats returns: each float metric of its
    metric_results (raw_rmse popped) with _mean and _std."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jstate, "task", JaxDoorTask)
        metrics = jmetrics.metric_results(np.ones(3), 1.0, 1.0, verbose=False)
    metrics.pop("raw_rmse")
    return {f"{k}_{s}" for k in metrics for s in ("mean", "std")}


@pytest.mark.parametrize("batched", ["0", "1"], ids=["sequential", "batched"])
def test_run_eval_stats_gives_jax_keys(configured, monkeypatch, batched):
    monkeypatch.setenv("MMF_TPU_EVAL_BATCH_REPEATS", batched)
    monkeypatch.setenv("MMF_TPU_EVAL_BATCH_REPEATS_CAP", "8")  # 2 repeats a rollout
    stats = teval.run_eval_stats(repeats=2)
    assert stats.keys() == _jax_stat_keys() == STAT_KEYS
    assert all(np.isfinite(v) for v in stats.values())
    assert stats["theta_rmse_deg_std"] > 0  # two repeats, two draws


@pytest.fixture(scope="module")
def tiny_data_dir(tmp_path_factory):
    """One trajectory a file of 16-19 steps: the CLI runs 20 repeats."""
    path = tmp_path_factory.mktemp("door_cli_cache")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MMF_TPU_SYNTH_T", "16")
        mp.setenv("MMF_TPU_SYNTH_TRAJ", "1")
        for seed, name in enumerate(EVAL_FILES):
            synthetic.synthesize_named_dataset(name, str(path / name), seed=seed)
    return path


def test_eval_cli_from_a_saved_checkpoint(tiny_data_dir, models, tmp_path, monkeypatch):
    """The CLI rebuilds the model from the metadata, loads the checkpoint
    bit for bit, runs run_eval_stats at its defaults (20 repeats, batched)
    and, with --save, writes the stats into the metadata."""
    data_dir = tiny_data_dir
    monkeypatch.chdir(tmp_path)  # Buddy's default directories
    monkeypatch.setattr(cache, "_cache_path", None)  # the CLI sets it
    monkeypatch.setenv("MMF_TPU_OFFLINE", "1")
    monkeypatch.setenv("MMF_TPU_EVAL_DEVICE_THROUGHPUT", "0")
    monkeypatch.setenv("MMF_TPU_EVAL_BATCH_REPEATS", "0")  # the CLI sets it
    # The JAX model's weights (the port's seeded init is torch's truncated
    # normal, whose draws differ between torch versions).
    saved = tdoor.DoorCrossmodalParticleFilter(device="cpu", seed=4)
    saved.load_jax_params(models[0].params)
    buddy = Buddy("cli", saved, verbose=False)
    buddy.set_metadata({"model_type": "DoorCrossmodalParticleFilter",
                        "dataset_args": DATASET_ARGS})
    buddy.save_checkpoint("phase_3")

    results = eval_door.main(["--experiment-name", "cli", "--device", "cpu", "--save"],
                             cache_dir=str(data_dir))
    assert results.keys() == STAT_KEYS
    assert all(np.isfinite(v) for v in results.values())
    loaded = teval.filter_model
    assert type(loaded) is tdoor.DoorCrossmodalParticleFilter and loaded is not saved
    for (k, a), (k2, b) in zip(saved.params.state_dict().items(),
                               loaded.params.state_dict().items()):
        assert k == k2 and torch.equal(a, b), k
    meta = json.loads((tmp_path / "metadata" / "cli.json").read_text())
    assert meta["eval_results_stats"] == results
    assert meta["model_type"] == "DoorCrossmodalParticleFilter"


@pytest.mark.parametrize("argv,item", [
    (["--data-parallel", "2"], "A13"), (["--pipeline-stages", "2"], "A13"),
    (["--serving"], "A8"),
])
def test_eval_cli_refuses_what_is_not_ported(tiny_data_dir, tmp_path, monkeypatch, argv,
                                             item):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(cache, "_cache_path", None)
    monkeypatch.setenv("MMF_TPU_SERVING", "0")
    monkeypatch.setenv("MMF_TPU_EVAL_BATCH_REPEATS", "0")
    Buddy("refused", verbose=False).set_metadata(
        {"model_type": "DoorParticleFilter", "dataset_args": DATASET_ARGS})
    with pytest.raises(NotImplementedError, match=item):
        eval_door.main(["--experiment-name", "refused", "--device", "cpu", *argv],
                       cache_dir=str(tiny_data_dir))


def test_configure_refuses_a_mesh(models, tmp_path):
    buddy = Buddy("mesh", models[1], log_dir=str(tmp_path), verbose=False)
    with pytest.raises(NotImplementedError, match="A13"):
        teval.configure(buddy=buddy, task=DoorTask, dataset_args=DATASET_ARGS,
                        mesh=object())

