"""Training of the Kalman filters, the port against the JAX package on the
CPU: ``train_virtual_sensor`` for one epoch, the e2e loss and every gradient
of one batch through the EKF's Jacobian (second order through the dynamics'
gate) with measurement init and through the crossmodal KF, and one
``train_e2e`` epoch of the EKF with ``measurement_initialize`` False and
True, and of the crossmodal and unimodal KFs with it True.

Small widths (units 16 through the ``_defs`` builders), B = 4, L = 3, fp32
on both sides; the same numpy weights (``load_jax_params``) and the same
batches (both packages draw the batch order from
``default_rng(optimizer_steps + 1)``). The Kalman filters draw no random
numbers, so nothing is replayed.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crossmodal.door_models import _defs as jdefs
from multimodalfilter_tpu import filtering as jf
from multimodalfilter_tpu import train as jtrain
from multimodalfilter_tpu.data import SingleStepDataset as JaxSingleStepDataset
from multimodalfilter_tpu.data import SubsequenceDataset as JaxSubsequenceDataset
from multimodalfilter_tpu.experiments import Buddy as JaxBuddy
from multimodalfilter_tpu.filtering import wrappers as jwrappers
from multimodalfilter_tpu.types import Trajectory as JaxTrajectory
from multimodalfilter_tpu_torch import filtering as tf
from multimodalfilter_tpu_torch import train as ttrain
from multimodalfilter_tpu_torch.crossmodal.door_models import _defs as tdefs
from multimodalfilter_tpu_torch.data import SingleStepDataset, SubsequenceDataset
from multimodalfilter_tpu_torch.experiments import Buddy
from multimodalfilter_tpu_torch.train import loops as tloops
from multimodalfilter_tpu_torch.types import Trajectory
from multimodalfilter_tpu_torch.weights import params_from_jax
from test_torch_port_kf_fusion import UNITS, _build, numpy_params

B, L = 4, 3
# As tests/test_torch_port_train_e2e.py: the loss of one batch relative;
# gradients per parameter relative to its largest entry (1e-3; the image
# encoder's first three convolutions 5e-2 against JAX, whose convolution
# backward sums ~10^4 terms in another order); Adam updates after an epoch
# in relative L2 norm (1e-1 against 1.0 for a wrong update). A gradient that
# is zero up to rounding gives Adam-normalised noise on both sides: those
# parameters are left out of the update check, as there.
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-3
JAX_CONV_GRAD_RTOL = 5e-2
ZERO_GRAD_ATOL = 1e-6
UPDATE_RTOL = 1e-1
_COARSE = tuple(f"observation_image_layers.{layer}."
                for layer in ("conv1", "resblock_conv", "conv2"))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread while this module runs (the suite runs in several
    worker processes at once). Restored after the module."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _trajectories(cls, count=2, t=12, seed=0):
    r = np.random.default_rng(seed)
    out = []
    for _ in range(count):
        obs = {"image": r.normal(size=(t, 32, 32)).astype(np.float32),
               "gripper_pos": r.normal(size=(t, 3)).astype(np.float32),
               "gripper_sensors": r.normal(size=(t, 7)).astype(np.float32)}
        out.append(cls(0.3 * r.normal(size=(t, 3)).astype(np.float32), obs,
                       r.normal(size=(t, 7)).astype(np.float32)))
    return out


def _ekf(defs):
    pkg = jf if defs is jdefs else tf
    return pkg.VirtualSensorEKFDef(dynamics_model=defs.dynamics_def(units=UNITS),
                                   virtual_sensor_model=defs.virtual_sensor_def(units=UNITS),
                                   state_dim=3)


def _defs(kind, defs):
    return _ekf(defs) if kind == "ekf" else _build(kind, defs)


@pytest.fixture(scope="module")
def weights():
    """kind -> (JAX def, numpy params)."""
    out = {}
    for i, kind in enumerate(("ekf", "cmkf", "ukf")):
        jdef = _defs(kind, jdefs)
        out[kind] = (jdef, numpy_params(jdef, 100 + i))
    return out


def _models(weights, kind):
    """(JAX facade, port facade) of `kind`, the same weights, nothing frozen."""
    jdef, params = weights[kind]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jwrappers.jax, "jit", lambda fn: lambda *a: jax.eval_shape(fn, *a))
        jm = jwrappers.StatefulFilter(jdef)
    jm.params = jax.tree_util.tree_map(jnp.array, params)
    tm = tf.StatefulFilter(_defs(kind, tdefs), device="cpu")
    tm.load_jax_params(params)
    return jm, tm


def _buddies(jm, tm, tmp_path):
    jbuddy = JaxBuddy("kf", jm, checkpoint_dir=str(tmp_path), metadata_dir=str(tmp_path),
                      log_dir=str(tmp_path / "jax"), verbose=False)
    return jbuddy, Buddy("kf", tm, log_dir=str(tmp_path / "torch"))


def _port_params(tm):
    return {k: v.detach().clone() for k, v in tm.params.state_dict().items()}


def _assert_updates_close(jm, tm, start, what, skip=()):
    want, got = params_from_jax(jax.tree_util.tree_map(np.asarray, jm.params)), _port_params(tm)
    assert want.keys() == got.keys()
    moved = 0
    for k in want:
        if k.startswith(skip):
            continue
        dj, dt = want[k] - start[k], got[k] - start[k]
        if not dj.any():
            assert not dt.any(), f"{what} {k} moved"
            continue
        moved += 1
        rel = float((dt - dj).norm() / dj.norm())
        assert rel <= UPDATE_RTOL, f"{what} {k}: update differs by {rel:.3g} of its norm"
    assert moved


def test_train_virtual_sensor_epoch_matches_jax(weights, tmp_path):
    """One epoch of virtual-sensor pretraining on the EKF: the loss, the batch
    order and the sensor's updates; the dynamics does not move."""
    jm, tm = _models(weights, "ekf")
    start = _port_params(tm)
    jbuddy, tbuddy = _buddies(jm, tm, tmp_path)
    jloss = jtrain.train_virtual_sensor(
        jbuddy, jm, JaxSingleStepDataset(_trajectories(JaxTrajectory)), epochs=1,
        batch_size=8)
    tloss = ttrain.train_virtual_sensor(
        tbuddy, tm, SingleStepDataset(_trajectories(Trajectory)), epochs=1, batch_size=8)
    assert tbuddy.optimizer_steps == jbuddy.optimizer_steps == 2
    np.testing.assert_allclose(tloss, jloss, rtol=LOSS_RTOL)
    _assert_updates_close(jm, tm, start, "virtual sensor")
    assert all(torch.equal(v, start[k]) for k, v in _port_params(tm).items()
               if k.startswith("dynamics_model."))


def _batch():
    ds = SubsequenceDataset(_trajectories(Trajectory, count=1), L)
    idx = np.arange(B)
    return {"states": ds.states[idx], "controls": ds.controls[idx],
            "obs": {k: v[idx] for k, v in ds.observations.items()}}


def _jax_e2e_loss(defn, enabled, measurement_initialize):
    """JAX train/loops.py:387-413 (the loss of train_e2e), as a function."""

    def loss_fn(params, batch):
        states = jnp.swapaxes(batch["states"], 0, 1)
        controls = jnp.swapaxes(batch["controls"], 0, 1)
        obs = jax.tree_util.tree_map(lambda a: jnp.swapaxes(a, 0, 1), batch["obs"])
        if measurement_initialize:
            obs0 = jax.tree_util.tree_map(lambda a: a[0], obs)
            belief = (defn.measurement_initialize_beliefs(params, obs0, enabled=enabled)
                      if enabled is not None else
                      defn.measurement_initialize_beliefs(params, obs0))
        else:
            cov = jnp.broadcast_to(jnp.eye(3) * 0.1, (states.shape[1], 3, 3))
            belief = defn.initialize_beliefs(params, None, states[0], cov, train=True)
        _, est = defn.forward_loop(params, belief,
                                   jax.tree_util.tree_map(lambda a: a[1:], obs),
                                   controls[1:], None, train=True, enabled=enabled)
        return jnp.mean((est - states[1:]) ** 2)

    return loss_fn


@pytest.mark.parametrize("kind,enabled,measurement_initialize", [
    ("ekf", None, True), ("cmkf", (True, True), False)])
def test_e2e_loss_and_gradients_match_jax(weights, kind, enabled, measurement_initialize):
    """The loss of one batch and the gradient of every parameter: BPTT
    through F (the dynamics' Jacobian) into the dynamics weights, and
    through the measurement init into the virtual sensor."""
    jdef, params = weights[kind]
    batch = _batch()
    jloss, jgrads = jax.jit(jax.value_and_grad(
        _jax_e2e_loss(jdef, enabled, measurement_initialize)))(
        params, jax.tree_util.tree_map(jnp.asarray, batch))
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, jgrads))

    _, tm = _models(weights, kind)
    with torch.enable_grad():  # other test files may switch it off (C1)
        loss = tloops.e2e_loss(tm.definition, tloops._to_device(batch, torch.device("cpu")),
                               enabled=enabled, initial_cov_scale=0.1, generator=None,
                               measurement_initialize=measurement_initialize)
        loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=LOSS_RTOL)
    got = {k: p.grad for k, p in tm.params.named_parameters()}
    assert got.keys() == want.keys()
    for k, g in got.items():
        scale = float(want[k].abs().max())
        if scale <= ZERO_GRAD_ATOL:  # the loss does not reach it
            assert g is None or float(g.abs().max()) <= ZERO_GRAD_ATOL, k
            continue
        rtol = JAX_CONV_GRAD_RTOL if any(c in k for c in _COARSE) else GRAD_RTOL
        torch.testing.assert_close(g, want[k], atol=rtol * scale, rtol=0,
                                   msg=lambda m, k=k: f"{k}: {m}")
    assert float(got["dynamics_model.shared_dense_out.weight"].abs().max()
                 if kind == "ekf" else
                 got["filter_models.0.dynamics_model.shared_dense_out.weight"].abs().max()) > 0


@pytest.mark.parametrize("kind,measurement_initialize", [
    ("ekf", False), ("ekf", True), ("cmkf", True), ("ukf", True)])
def test_train_e2e_epoch_matches_jax(weights, kind, measurement_initialize, tmp_path):
    """One train_e2e epoch in each package: the losses and every parameter's
    update. The fusion KFs' measurement init takes the enabled modalities,
    the plain EKF's none."""
    jm, tm = _models(weights, kind)
    start = _port_params(tm)
    jbuddy, tbuddy = _buddies(jm, tm, tmp_path)
    kwargs = dict(epochs=1, batch_size=B, measurement_initialize=measurement_initialize)
    jloss = jtrain.train_e2e(jbuddy, jm, JaxSubsequenceDataset(
        _trajectories(JaxTrajectory), L), **kwargs)
    tloss = ttrain.train_e2e(tbuddy, tm, SubsequenceDataset(_trajectories(Trajectory), L),
                             **kwargs)
    assert tbuddy.optimizer_steps == jbuddy.optimizer_steps == 2
    np.testing.assert_allclose(tloss, jloss, rtol=LOSS_RTOL)
    _assert_updates_close(jm, tm, start, f"{kind} e2e")


def test_measurement_initialize_draws_no_noise(weights, monkeypatch):
    """The e2e loss of a Kalman filter draws nothing, with or without
    measurement init."""
    _, tm = _models(weights, "cmkf")
    monkeypatch.setattr(tloops, "draw_noise", lambda *a: pytest.fail("drew noise"))
    batch = tloops._to_device(_batch(), torch.device("cpu"))
    for mi in (False, True):
        with torch.no_grad():
            loss = tloops.e2e_loss(dataclasses.replace(tm.definition), batch,
                                   enabled=(True, False), initial_cov_scale=0.1,
                                   generator=None, measurement_initialize=mi)
        assert torch.isfinite(loss)
