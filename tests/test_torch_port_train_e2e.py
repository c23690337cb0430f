"""E2E BPTT training of the door crossmodal PF, the port against the JAX
package on the CPU, at full width (units=64) and a small size (B=4, L=4,
M=8): one batch's loss and every gradient (JAX with ``pallas_resample=True``,
so its B2 custom VJP runs in interpret mode), a whole ``train_e2e`` epoch
(the default JAX facade), and the door curriculum's phase-3 switch of
``enabled_models`` under one optimizer.

Both sides get the same weights (``load_jax_params``) and the same noise:
the JAX side draws it from its key chain, and the tests repeat those draws
with ``jax.random`` and hand them to the port through
``train.loops.draw_noise``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crossmodal import door_models as jdoor
from multimodalfilter_tpu import train as jtrain
from multimodalfilter_tpu.data import SubsequenceDataset as JaxSubsequenceDataset
from multimodalfilter_tpu.experiments import Buddy as JaxBuddy
from multimodalfilter_tpu.train import loops as jloops
from multimodalfilter_tpu.types import Trajectory as JaxTrajectory
from multimodalfilter_tpu_torch import train as ttrain
from multimodalfilter_tpu_torch.crossmodal import door_models as tdoor
from multimodalfilter_tpu_torch.data import SubsequenceDataset
from multimodalfilter_tpu_torch.experiments import Buddy
from multimodalfilter_tpu_torch.train import loops as tloops
from multimodalfilter_tpu_torch.types import Trajectory
from multimodalfilter_tpu_torch.weights import params_from_jax

B, L, M = 4, 4, 8


def _trajectories(cls, count=3, t=16, seed=0):
    r = np.random.default_rng(seed)
    out = []
    for _ in range(count):
        obs = {"image": r.normal(size=(t, 32, 32)).astype(np.float32),
               "gripper_pos": r.normal(size=(t, 3)).astype(np.float32),
               "gripper_sensors": r.normal(size=(t, 7)).astype(np.float32)}
        out.append(cls(0.3 * r.normal(size=(t, 3)).astype(np.float32), obs,
                       r.normal(size=(t, 7)).astype(np.float32)))
    return out


@pytest.fixture(scope="module")
def initial():
    """Seeded JAX weights, kept as numpy copies (training donates buffers)."""
    jm = jdoor.DoorCrossmodalParticleFilter()
    return jm, jax.tree_util.tree_map(np.array, jm.params)


def _models(initial):
    jm, params = initial
    jm.params = jax.tree_util.tree_map(jnp.array, params)
    jm.definition = dataclasses.replace(jm.definition, num_particles_train=M)
    jm.enabled_models = [True, True]
    jm.frozen_paths.clear()
    tm = tdoor.DoorCrossmodalParticleFilter(device="cpu")
    tm.load_jax_params(params)
    tm.definition = dataclasses.replace(tm.definition, num_particles_train=M)
    return jm, tm


def _batch_noise(key, b=B, m=M, seq_len=L):
    """The JAX e2e loss's draws for one batch key: normal(k_init, (B, M, D))
    for the initial belief (pf.py:101), then forward_loop's hoisted eps
    (pf.py:264-280) from k_loop."""
    k_init, k_loop = jax.random.split(key)
    eps0 = jax.random.normal(k_init, (b, m, 3))
    pairs = jax.vmap(jax.random.split)(jax.random.split(k_loop, seq_len - 1))
    eps_seq = jax.vmap(lambda k: jax.random.normal(k, (b * m, 3)))(pairs[:, 0])
    return np.array(eps0), np.array(eps_seq)


def _epoch_noise(rng, num_batches):
    """What one JAX ``_run_epochs`` epoch draws: root._next_key(), split per
    batch (loops.py:101, :136)."""
    _, key = jax.random.split(rng)
    return [_batch_noise(k) for k in jax.random.split(key, num_batches)]


def _replay(monkeypatch, draws):
    queue = list(draws)

    def replayed(generator, shapes, device):
        out = queue.pop(0)
        assert [tuple(s) for s in shapes] == [x.shape for x in out]
        return tuple(torch.from_numpy(x).to(device) for x in out)

    monkeypatch.setattr(tloops, "draw_noise", replayed)
    return queue


def _port_params(tm):
    return {k: v.detach().clone() for k, v in tm.params.state_dict().items()}


def _jax_params(jm):
    return params_from_jax(jax.tree_util.tree_map(np.asarray, jm.params))


def _jax_e2e_loss(defn, enabled):
    """JAX train/loops.py:387-413 (the loss of train_e2e), as a function."""

    def loss_fn(params, batch, key):
        states = jnp.swapaxes(batch["states"], 0, 1)
        controls = jnp.swapaxes(batch["controls"], 0, 1)
        obs = jax.tree_util.tree_map(lambda a: jnp.swapaxes(a, 0, 1), batch["obs"])
        k_init, k_loop = jax.random.split(key)
        b = states.shape[1]
        cov = jnp.broadcast_to(jnp.eye(3) * 0.1, (b, 3, 3))
        belief = defn.initialize_beliefs(params, k_init, states[0], cov, train=True)
        _, est = defn.forward_loop(
            params, belief, jax.tree_util.tree_map(lambda a: a[1:], obs),
            controls[1:], k_loop, train=True, enabled=enabled,
        )
        return jnp.mean((est - states[1:]) ** 2)

    return loss_fn


# The loss of one batch: fp32 conv and 64-wide trunks in two frameworks,
# reassociated sums carried through L-1 = 3 steps of the recursion.
LOSS_RTOL = 1e-5
# Gradients, per parameter, relative to that parameter's largest gradient
# entry. Against a float64 run of the port, the port's fp32 gradients are
# within 4.1e-4 (the gate's first conv, the same for JAX) and JAX's within
# 2.6e-2 on the image likelihood model's conv1, resblock_conv and conv2
# (XLA:CPU's convolution backward sums ~10^4 terms in another order): so
# 1e-3 against float64 and against JAX, except 5e-2 against JAX on those
# three layers. With one modality enabled, the gate's gradient and that of
# the enabled likelihood model's output bias are zero (each shifts every
# particle of a row alike, and normalisation removes that): where the
# float64 gradient is zero to rounding, both sides must give rounding noise
# only.
GRAD_RTOL = 1e-3
JAX_CONV_GRAD_RTOL = 5e-2
ZERO_GRAD_ATOL = 1e-6
_IMAGE = "measurement_model.measurement_models.0.obs_encoders.observation_image_layers."
_JAX_COARSE = tuple(_IMAGE + layer for layer in ("conv1.", "resblock_conv.", "conv2."))
_GATE = "measurement_model.crossmodal_weight_model."


def _port_loss_and_grads(tm, batch_np, noise, enabled, dtype):
    model = tdoor.DoorCrossmodalParticleFilter(device="cpu")
    model.params.load_state_dict(tm.params.state_dict())
    model.params.to(dtype)
    batch = tloops._to_device(batch_np, torch.device("cpu"))
    batch = {k: ({kk: vv.to(dtype) for kk, vv in v.items()} if isinstance(v, dict)
                 else v.to(dtype)) for k, v in batch.items()}
    defn = dataclasses.replace(model.definition, num_particles_train=M)
    tloops.draw_noise = lambda generator, shapes, device: tuple(
        torch.from_numpy(x).to(dtype) for x in noise)
    with torch.enable_grad():  # other test files may switch it off (C1)
        loss = tloops.e2e_loss(defn, batch, enabled=enabled, initial_cov_scale=0.1,
                               generator=None)
        loss.backward()
    return float(loss.detach()), {k: p.grad for k, p in model.params.named_parameters()}


@pytest.mark.parametrize("enabled", [(True, True), (False, True)])
def test_e2e_loss_and_gradients_match_jax(initial, enabled, monkeypatch):
    jm, tm = _models(initial)
    ds = SubsequenceDataset(_trajectories(Trajectory, count=1), L)
    idx = np.arange(B)
    batch_np = {"states": ds.states[idx], "controls": ds.controls[idx],
                "obs": {k: v[idx] for k, v in ds.observations.items()}}
    key = jax.random.PRNGKey(7)
    defn = dataclasses.replace(jm.definition, pallas_resample=True)
    jloss, jgrads = jax.value_and_grad(_jax_e2e_loss(defn, enabled))(
        jm.params, jax.tree_util.tree_map(jnp.asarray, batch_np), key
    )
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, jgrads))

    monkeypatch.setattr(tloops, "draw_noise", tloops.draw_noise)  # restored after
    noise = _batch_noise(key)
    loss, got = _port_loss_and_grads(tm, batch_np, noise, enabled, torch.float32)
    loss64, exact = _port_loss_and_grads(tm, batch_np, noise, enabled, torch.float64)
    np.testing.assert_allclose(loss, float(jloss), rtol=LOSS_RTOL)
    np.testing.assert_allclose(loss, loss64, rtol=LOSS_RTOL)

    assert want.keys() == got.keys()
    for k in want:
        if not enabled[0] and k.startswith("measurement_model.measurement_models.0."):
            assert got[k] is None and not want[k].any(), k  # disabled: no gradient
            continue
        scale = float(exact[k].abs().max())
        if scale <= 1e-12:
            assert max(float(got[k].abs().max()), float(want[k].abs().max())) \
                <= ZERO_GRAD_ATOL, k
            continue
        torch.testing.assert_close(got[k].double(), exact[k], atol=GRAD_RTOL * scale,
                                   rtol=0, msg=lambda m, k=k: f"{k} vs float64: {m}")
        rtol = JAX_CONV_GRAD_RTOL if k.startswith(_JAX_COARSE) else GRAD_RTOL
        torch.testing.assert_close(got[k], want[k], atol=rtol * scale, rtol=0,
                                   msg=lambda m, k=k: f"{k} vs JAX: {m}")


# After a few Adam steps from equal weights. Adam divides each entry's
# moment by its own gradient scale, so entries whose gradients are a few
# orders above eps = 1e-8 (the gate's image encoder, which reaches the loss
# only through the log-weight gate) turn fp32 differences of the gradient
# into O(lr) differences of the update. Each parameter's update (its change
# over the run) is held in relative L2 norm: measured at most 3.4e-2 after 3
# steps with both modalities and 5.1e-2 with one (the last resblock bias of
# the enabled likelihood model, whose gradient nearly cancels for the reason
# given above), against 1.0 for an update that is wrong. A gradient that is
# zero up to rounding (with one modality enabled: the gate and the
# likelihood models' output biases) gives updates that are Adam-normalised
# noise in both frameworks: those are left out.
UPDATE_RTOL = 1e-1
_NOISE_WITH_ONE_MODALITY = (_GATE,) + tuple(
    f"measurement_model.measurement_models.{i}.shared_dense_out.bias" for i in (0, 1)
)


def _assert_updates_close(jm, tm, start, rtol, what, skip=()):
    want, got = _jax_params(jm), _port_params(tm)
    for k in want:
        if k.startswith(skip):
            continue
        dj, dt = want[k] - start[k], got[k] - start[k]
        if not dj.any():  # a model disabled since a fresh optimizer: no step
            assert not dt.any(), f"{what} {k} moved"
            continue
        rel = float((dt - dj).norm() / dj.norm())
        assert rel <= rtol, f"{what} {k}: update differs by {rel:.3g} of its norm"


def _record(monkeypatch, module, orders):
    real = module._epoch_index_matrix

    def recording(rng, n, batch_size):
        out = real(rng, n, batch_size)
        orders.append(np.array(out))
        return out

    monkeypatch.setattr(module, "_epoch_index_matrix", recording)


def _run_both(jm, tm, jbuddy, tbuddy, monkeypatch):
    """One train_e2e epoch in each package with the same noise; returns the
    two losses and the two batch orders."""
    jds = JaxSubsequenceDataset(_trajectories(JaxTrajectory), L)
    tds = SubsequenceDataset(_trajectories(Trajectory), L)
    jorder, torder = [], []
    _record(monkeypatch, jloops, jorder)
    _record(monkeypatch, tloops, torder)
    rng = jm._rng
    jloss = jtrain.train_e2e(jbuddy, jm, jds, epochs=1, batch_size=B)
    queue = _replay(monkeypatch, _epoch_noise(rng, len(jds) // B))
    tloss = ttrain.train_e2e(tbuddy, tm, tds, epochs=1, batch_size=B)
    assert not queue
    return jloss, tloss, jorder, torder


def _buddies(jm, tm, tmp_path):
    jbuddy = JaxBuddy("e2e", jm, checkpoint_dir=str(tmp_path), metadata_dir=str(tmp_path),
                      log_dir=str(tmp_path / "jax"), verbose=False)
    return jbuddy, Buddy("e2e", tm, log_dir=str(tmp_path / "torch"))


def test_train_e2e_epoch_matches_jax(initial, tmp_path, monkeypatch):
    jm, tm = _models(initial)
    start = _port_params(tm)
    jbuddy, tbuddy = _buddies(jm, tm, tmp_path)
    jloss, tloss, jorder, torder = _run_both(jm, tm, jbuddy, tbuddy, monkeypatch)
    assert len(jorder) == len(torder) == 1 and jorder[0].shape == (3, B)
    np.testing.assert_array_equal(jorder[0], torder[0])
    assert tbuddy.optimizer_steps == jbuddy.optimizer_steps == 3
    np.testing.assert_allclose(tloss, jloss, rtol=LOSS_RTOL)
    _assert_updates_close(jm, tm, start, UPDATE_RTOL, "after the epoch")


def test_phase3_enabled_switch_keeps_moving_the_disabled_model(initial, tmp_path,
                                                               monkeypatch):
    """train_door.py:162-176: phase 2 trains with the image model only,
    phase 3 switches to pos+sensors under the same optimizer name. JAX keeps
    stepping the image model on its decaying Adam moments; so must the
    port."""
    jm, tm = _models(initial)
    start = _port_params(tm)
    jbuddy, tbuddy = _buddies(jm, tm, tmp_path)
    for model in (jm, tm):
        model.measurement_model.enabled_models = [True, False]
    _run_both(jm, tm, jbuddy, tbuddy, monkeypatch)
    _assert_updates_close(jm, tm, start, UPDATE_RTOL, "phase 2", skip=_NOISE_WITH_ONE_MODALITY)

    image = "measurement_model.measurement_models.0."
    before = {k: v for k, v in _port_params(tm).items() if k.startswith(image)}
    for model in (jm, tm):
        model.measurement_model.enabled_models = [False, True]
    monkeypatch.undo()
    _run_both(jm, tm, jbuddy, tbuddy, monkeypatch)
    _assert_updates_close(jm, tm, start, UPDATE_RTOL, "phase 3", skip=_NOISE_WITH_ONE_MODALITY)
    after = _port_params(tm)
    assert all(not torch.equal(after[k], v) for k, v in before.items())
