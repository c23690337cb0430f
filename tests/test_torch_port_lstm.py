"""The LSTM baseline, ``DoorLSTMFilter``, the port against the JAX package on
the CPU at full width (units 64, two cells of hidden size 512): the flax
param tree carried across, ``forward_loop``, the e2e loss and every
gradient, one ``train_e2e`` epoch, and ``run_eval`` on a tiny synthetic door
set. The filter draws no random numbers, so nothing is replayed and
``run_eval``'s whole RMSE is compared.

The JAX model is built with its init traced, not compiled (``eval_shape``),
and both sides then get the same weights, drawn from numpy (kernels with
variance 1/fan_in, biases 0.1 sigma, so that every bias is exercised).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import crossmodal.eval_helpers as jeval
import multimodalfilter_tpu.data.cache as jcache
from crossmodal import door_models as jdoor
from crossmodal.tasks import DoorTask as JaxDoorTask
from multimodalfilter_tpu import train as jtrain
from multimodalfilter_tpu.data import SubsequenceDataset as JaxSubsequenceDataset
from multimodalfilter_tpu.experiments import Buddy as JaxBuddy
from multimodalfilter_tpu.filtering import wrappers as jwrappers
from multimodalfilter_tpu.types import Trajectory as JaxTrajectory
from multimodalfilter_tpu_torch import train as ttrain
from multimodalfilter_tpu_torch.crossmodal import door_models as tdoor
from multimodalfilter_tpu_torch.crossmodal import eval_helpers as teval
from multimodalfilter_tpu_torch.crossmodal.tasks import DoorTask
from multimodalfilter_tpu_torch.data import SubsequenceDataset, cache, synthetic
from multimodalfilter_tpu_torch.experiments import Buddy
from multimodalfilter_tpu_torch.filtering import LSTMFilterDef
from multimodalfilter_tpu_torch.train import loops as tloops
from multimodalfilter_tpu_torch.types import Trajectory
from multimodalfilter_tpu_torch.weights import params_from_jax

N, T = 3, 6  # forward_loop
B, L = 4, 4  # e2e batch and window
EPOCH_B = 2  # the epoch's batch
# Estimates after T steps: fp32 convs and 512-wide GEMMs in two frameworks
# (the port sums a cell's input and recurrent products in one GEMM, flax in
# two), carried through the recursion.
LOOP_ATOL = 1e-5
# As tests/test_torch_port_train_e2e.py: the loss of one batch relative;
# gradients per parameter relative to its largest entry, 1e-3 against a
# float64 run of the port and against JAX, except 5e-2 against JAX on the
# image encoder's first three conv layers (XLA:CPU's convolution backward
# sums ~10^4 terms in another order); Adam updates after an epoch in
# relative L2 norm.
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-3
JAX_CONV_GRAD_RTOL = 5e-2
UPDATE_RTOL = 1e-1
_JAX_COARSE = tuple(f"obs_encoders.observation_image_layers.{layer}."
                    for layer in ("conv1", "resblock_conv", "conv2"))
# run_eval's RMSE: a root mean square over the same (step, trajectory) grid
# of estimates that agree within LOOP_ATOL, relative to the RMSE's scale.
RMSE_RTOL = 1e-5
EVAL_FILES = ("panda_door_pull_10.hdf5", "panda_door_push_10.hdf5")
DATASET_ARGS = dict(use_vision=True, use_proprioception=True, use_haptics=True,
                    image_blackout_ratio=0.0, sequential_image_rate=1)


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


def _numpy_tree(shapes, seed):
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        if path[-1].key == "bias":
            return (0.1 * rng.normal(size=leaf.shape)).astype(np.float32)
        fan_in = int(np.prod(leaf.shape[:-1]))
        return (rng.normal(size=leaf.shape) / np.sqrt(fan_in)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


@pytest.fixture(scope="module")
def weights():
    """(the JAX model, its param tree as numpy)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jwrappers.jax, "jit", lambda fn: lambda *a: jax.eval_shape(fn, *a))
        jm = jdoor.DoorLSTMFilter()
    return jm, _numpy_tree(jm.params, seed=0)


def _models(weights):
    jm, tree = weights
    jm.params = jax.tree_util.tree_map(jnp.asarray, tree)
    jm.frozen_paths.clear()
    tm = tdoor.DoorLSTMFilter(device="cpu")
    tm.load_jax_params(tree)
    return jm, tm


def _sequences(t, n, seed):
    r = np.random.default_rng(seed)
    obs = {"image": r.normal(size=(t, n, 32, 32)).astype(np.float32),
           "gripper_pos": r.normal(size=(t, n, 3)).astype(np.float32),
           "gripper_sensors": r.normal(size=(t, n, 7)).astype(np.float32)}
    return obs, r.normal(size=(t, n, 7)).astype(np.float32)


def _trajectories(cls, count=3, t=16, seed=0):
    obs, controls = _sequences(t, count, seed)
    states = 0.3 * np.random.default_rng(seed + 1).normal(size=(t, count, 3))
    return [cls(states[:, i].astype(np.float32), {k: v[:, i] for k, v in obs.items()},
                controls[:, i]) for i in range(count)]


def test_params_from_flax(weights):
    """The eight denses of each cell carry across with the Dense transpose,
    under flax's names; a leftover leaf or a missing one raises."""
    jm, tree = weights
    tm = tdoor.DoorLSTMFilter(device="cpu")
    state = params_from_jax(tree)
    assert state.keys() == tm.params.state_dict().keys()
    assert {k for k in state if k.startswith("lstm_0.")} == {
        f"lstm_0.{d}.{p}" for d, p in [(f"i{g}", "weight") for g in "ifgo"]
        + [(f"h{g}", q) for g in "ifgo" for q in ("weight", "bias")]}
    np.testing.assert_array_equal(state["lstm_1.if.weight"].numpy(),
                                  tree["lstm_1"]["if"]["kernel"].T)
    np.testing.assert_array_equal(state["lstm_0.ho.bias"].numpy(),
                                  tree["lstm_0"]["ho"]["bias"])
    extra = {**tree, "lstm_1": {**tree["lstm_1"], "hx": tree["lstm_1"]["hi"]}}
    with pytest.raises(RuntimeError, match="Unexpected key"):
        tm.load_jax_params(extra)
    missing = {**tree, "lstm_1": {k: v for k, v in tree["lstm_1"].items() if k != "io"}}
    with pytest.raises(RuntimeError, match="Missing key"):
        tm.load_jax_params(missing)


def test_forward_loop_matches_jax(weights):
    jm, tm = _models(weights)
    obs, controls = _sequences(T, N, seed=1)
    mean = np.zeros((N, 3), np.float32)
    cov = np.tile(np.eye(3, dtype=np.float32) * 0.1, (N, 1, 1))
    jm.eval()
    tm.eval()
    jm.initialize_beliefs(mean=jnp.asarray(mean), covariance=jnp.asarray(cov))
    want = np.asarray(jm.forward_loop(observations=jax.tree_util.tree_map(jnp.asarray, obs),
                                      controls=jnp.asarray(controls)))
    tm.initialize_beliefs(mean=mean, covariance=cov)
    assert all(not x.any() for layer in tm.belief for x in layer)  # the zero carry
    got = tm.forward_loop(observations=obs, controls=controls).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=LOOP_ATOL)
    for (jc, jh), (tc, th) in zip(jm.belief, tm.belief):  # the carry is (c, h)
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0, atol=LOOP_ATOL)
        np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=0, atol=LOOP_ATOL)
    # One facade step continues from the carry as the loop's next step does.
    o1, c1 = _sequences(1, N, seed=2)
    one = tm.forward(observations={k: v[0] for k, v in o1.items()}, controls=c1[0])
    want1 = np.asarray(jm.forward(observations={k: jnp.asarray(v[0]) for k, v in o1.items()},
                                  controls=jnp.asarray(c1[0])))
    np.testing.assert_allclose(one.detach().numpy(), want1, rtol=0, atol=LOOP_ATOL)


def _jax_e2e_loss(defn):
    """The JAX package's e2e loss (train/loops.py:387-413) as a function."""

    def loss_fn(params, batch, key):
        states = jnp.swapaxes(batch["states"], 0, 1)
        controls = jnp.swapaxes(batch["controls"], 0, 1)
        obs = jax.tree_util.tree_map(lambda a: jnp.swapaxes(a, 0, 1), batch["obs"])
        k_init, k_loop = jax.random.split(key)
        cov = jnp.broadcast_to(jnp.eye(3) * 0.1, (states.shape[1], 3, 3))
        belief = defn.initialize_beliefs(params, k_init, states[0], cov, train=True)
        _, est = defn.forward_loop(params, belief,
                                   jax.tree_util.tree_map(lambda a: a[1:], obs),
                                   controls[1:], k_loop, train=True)
        return jnp.mean((est - states[1:]) ** 2)

    return loss_fn


def _no_draws(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("the LSTM's e2e loss drew noise")

    monkeypatch.setattr(tloops, "draw_noise", refuse)


def _port_loss_and_grads(tm, batch_np, dtype):
    model = tdoor.DoorLSTMFilter(device="cpu")
    model.params.load_state_dict(tm.params.state_dict())
    model.params.to(dtype)
    batch = tloops._to_device(batch_np, torch.device("cpu"))
    batch = {k: ({kk: vv.to(dtype) for kk, vv in v.items()} if isinstance(v, dict)
                 else v.to(dtype)) for k, v in batch.items()}
    with torch.enable_grad():  # other test files may switch it off (C1)
        loss = tloops.e2e_loss(model.definition, batch, enabled=None,
                               initial_cov_scale=0.1, generator=None)
        loss.backward()
    return float(loss.detach()), {k: p.grad for k, p in model.params.named_parameters()}


def test_e2e_loss_and_gradients_match_jax(weights, monkeypatch):
    jm, tm = _models(weights)
    assert isinstance(tm.definition, LSTMFilterDef)
    ds = SubsequenceDataset(_trajectories(Trajectory, count=1), L)
    idx = np.arange(B)
    batch_np = {"states": ds.states[idx], "controls": ds.controls[idx],
                "obs": {k: v[idx] for k, v in ds.observations.items()}}
    jloss, jgrads = jax.jit(jax.value_and_grad(_jax_e2e_loss(jm.definition)))(
        jm.params, jax.tree_util.tree_map(jnp.asarray, batch_np), jax.random.PRNGKey(7))
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, jgrads))

    _no_draws(monkeypatch)
    loss, got = _port_loss_and_grads(tm, batch_np, torch.float32)
    loss64, exact = _port_loss_and_grads(tm, batch_np, torch.float64)
    np.testing.assert_allclose(loss, float(jloss), rtol=LOSS_RTOL)
    np.testing.assert_allclose(loss, loss64, rtol=LOSS_RTOL)
    assert want.keys() == got.keys()
    for k in want:
        scale = float(exact[k].abs().max())
        assert scale > 0, k  # every parameter reaches the loss
        torch.testing.assert_close(got[k].double(), exact[k], atol=GRAD_RTOL * scale, rtol=0,
                                   msg=lambda m, k=k: f"{k} vs float64: {m}")
        rtol = JAX_CONV_GRAD_RTOL if k.startswith(_JAX_COARSE) else GRAD_RTOL
        torch.testing.assert_close(got[k], want[k], atol=rtol * scale, rtol=0,
                                   msg=lambda m, k=k: f"{k} vs JAX: {m}")


def _epoch_dataset(cls, dataset_cls):
    return dataset_cls(_trajectories(cls, count=1), L)


@pytest.fixture(scope="module")
def jax_epoch(weights, tmp_path_factory):
    """One JAX train_e2e epoch from the shared weights: (loss, optimizer
    steps, params after). Its compile is most of its time, so it runs once
    for the module."""
    jm, _ = _models(weights)
    path = tmp_path_factory.mktemp("lstm_epoch")
    jbuddy = JaxBuddy("lstm", jm, checkpoint_dir=str(path), metadata_dir=str(path),
                      log_dir=str(path / "jax"), verbose=False)
    loss = jtrain.train_e2e(jbuddy, jm, _epoch_dataset(JaxTrajectory, JaxSubsequenceDataset),
                            epochs=1, batch_size=EPOCH_B)
    return loss, jbuddy.optimizer_steps, params_from_jax(
        jax.tree_util.tree_map(np.asarray, jm.params))


def test_train_e2e_epoch_matches_jax(weights, jax_epoch, tmp_path, monkeypatch):
    """One train_e2e epoch (2 optimizer steps at B = 2, L = 4: XLA:CPU's
    convolution backward makes a larger JAX step cost seconds on one core)
    in each package from the same weights: the same loss, step count and
    Adam updates."""
    jloss, jsteps, want = jax_epoch
    _, tm = _models(weights)
    start = {k: v.detach().clone() for k, v in tm.params.state_dict().items()}
    tbuddy = Buddy("lstm", tm, log_dir=str(tmp_path / "torch"), verbose=False)
    _no_draws(monkeypatch)
    tloss = ttrain.train_e2e(tbuddy, tm, _epoch_dataset(Trajectory, SubsequenceDataset),
                             epochs=1, batch_size=EPOCH_B)
    assert tbuddy.optimizer_steps == jsteps == 2
    np.testing.assert_allclose(tloss, jloss, rtol=LOSS_RTOL)
    got = tm.params.state_dict()
    for k in want:
        dj, dt = want[k] - start[k], got[k] - start[k]
        assert dj.any(), k
        rel = float((dt - dj).norm() / dj.norm())
        assert rel <= UPDATE_RTOL, f"{k}: update differs by {rel:.3g} of its norm"


@pytest.fixture(scope="module")
def tiny_data_dir(tmp_path_factory):
    """One trajectory of 16-19 steps a file: N = 2."""
    path = tmp_path_factory.mktemp("lstm_eval_cache")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MMF_TPU_SYNTH_T", "16")
        mp.setenv("MMF_TPU_SYNTH_TRAJ", "1")
        for seed, name in enumerate(EVAL_FILES):
            synthetic.synthesize_named_dataset(name, str(path / name), seed=seed)
    return path


def test_run_eval_matches_jax(weights, tiny_data_dir, tmp_path, monkeypatch):
    monkeypatch.setenv("MMF_TPU_OFFLINE", "1")
    monkeypatch.setenv("MMF_TPU_EVAL_DEVICE_THROUGHPUT", "0")
    monkeypatch.setattr(jcache, "_cache_path", str(tiny_data_dir))
    monkeypatch.setattr(cache, "_cache_path", str(tiny_data_dir))
    jm, tm = _models(weights)
    jeval.configure(buddy=JaxBuddy("eval", jm, checkpoint_dir=str(tmp_path),
                                   metadata_dir=str(tmp_path), log_dir=str(tmp_path / "j"),
                                   verbose=False),
                    task=JaxDoorTask, dataset_args=dict(DATASET_ARGS))
    teval.configure(buddy=Buddy("eval", tm, log_dir=str(tmp_path / "t"), verbose=False),
                    task=DoorTask, dataset_args=dict(DATASET_ARGS))
    want = jeval.run_eval()
    got = teval.run_eval()
    scale = max(1.0, float(np.max(want["raw_rmse"])))
    np.testing.assert_allclose(got["raw_rmse"], want["raw_rmse"], rtol=0,
                               atol=RMSE_RTOL * scale)
    for key in ("theta_rmse_deg", "x_rmse_cm", "y_rmse_cm"):
        assert np.isfinite(got[key])
    assert dataclasses.is_dataclass(tm.definition) and tm.enabled_models is None
