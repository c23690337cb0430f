"""The EKF core of the port against the JAX package on the CPU: the Kalman
nets (``VirtualSensorNet``, ``KFWeightNet``), the door encoder factories,
``_kalman_update``, the dynamics Jacobian F of ``predict`` (against
``jax.jacfwd``, with and without hoisted control features), and
``VirtualSensorEKFDef``'s ``step``, ``forward_loop`` and
``measurement_initialize_beliefs``.

Small widths (units 16), N = 4, T = 8, fp32 on both sides; the same numpy
inputs and the same weights (``load_jax_params``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crossmodal.door_models import _defs as jdefs
from crossmodal.door_models import layers as jlayers
from multimodalfilter_tpu import models as jm
from multimodalfilter_tpu.filtering import VirtualSensorEKFDef as JaxEKFDef
from multimodalfilter_tpu.filtering.ekf import _kalman_update as jax_kalman_update
from multimodalfilter_tpu.types import GaussianBelief as JaxBelief
from multimodalfilter_tpu_torch import models as tm
from multimodalfilter_tpu_torch.crossmodal.door_models import _defs as tdefs
from multimodalfilter_tpu_torch.crossmodal.door_models import layers as tlayers
from multimodalfilter_tpu_torch.filtering import VirtualSensorEKFDef
from multimodalfilter_tpu_torch.filtering.ekf import _kalman_update
from multimodalfilter_tpu_torch.types import GaussianBelief
from multimodalfilter_tpu_torch.weights import load_jax_params
from test_torch_port_kf_fusion import numpy_params

UNITS, N, T = 16, 4, 8
# Nets: fp32 on both sides, sums in another order (XLA against PyTorch's CPU
# kernels) over at most 8192 inputs (the image encoder's dense).
NET_ATOL = 1e-5
# The Kalman update and F: a few fp32 products and a 3x3 Cholesky solve of
# O(1) values.
ALGEBRA_ATOL = 1e-5
# A loop of T = 8 EKF steps: the nets' rounding carried through the
# recursion, relative to the estimates' scale (O(1) at these weights).
LOOP_RTOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread while this module runs: the suite runs in several
    worker processes at once, and torch's default pool of one thread a core
    in each of them oversubscribes the machine. Restored after the module."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _obs(n, seed=0, lead=()):
    r = np.random.default_rng(seed)
    return {"image": r.normal(size=lead + (n, 32, 32)).astype(np.float32),
            "gripper_pos": r.normal(size=lead + (n, 3)).astype(np.float32),
            "gripper_sensors": r.normal(size=lead + (n, 7)).astype(np.float32)}


def _torch(tree):
    if isinstance(tree, dict):
        return {k: _torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.asarray(tree))


def _close(got, want, atol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=atol, rtol=0)


def _scale(x):
    return max(1.0, float(np.abs(np.asarray(x)).max()))


# --- Nets ---------------------------------------------------------------------


@pytest.mark.parametrize("noise_r", [None, (0.1, 0.2, 0.3)])
@pytest.mark.parametrize("modalities", [("image", "pos", "sensors"), ("pos", "sensors")])
def test_virtual_sensor_net_matches_flax(noise_r, modalities):
    obs = _obs(5)
    net = jm.VirtualSensorNet(3, modalities, UNITS, noise_R_tril_diag=noise_r)
    params = net.init(jax.random.PRNGKey(1), obs)["params"]
    port = tm.VirtualSensorNet(3, modalities, UNITS, noise_R_tril_diag=noise_r)
    load_jax_params(port, params)
    z, tril = net.apply({"params": params}, obs)
    with torch.no_grad():
        tz, ttril = port(_torch(obs))
    _close(tz, z, NET_ATOL)
    _close(ttril, tril, NET_ATOL)


def test_push_virtual_sensor_net_matches_flax():
    """The push task's encoder (the spanning-average-pool variant), once
    refused, is ported: the push virtual sensor (state 2) matches flax."""
    obs = _obs(5)
    net = jm.VirtualSensorNet(2, units=UNITS, spanning_avg_pool=True)
    params = net.init(jax.random.PRNGKey(3), obs)["params"]
    port = tm.VirtualSensorNet(2, units=UNITS, spanning_avg_pool=True)
    load_jax_params(port, params)
    z, tril = net.apply({"params": params}, obs)
    with torch.no_grad():
        tz, ttril = port(_torch(obs))
    _close(tz, z, NET_ATOL)
    _close(ttril, tril, NET_ATOL)


@pytest.mark.parametrize("reference_reshape", [False, True])
@pytest.mark.parametrize("weighting_type", ["sigmoid", "softmax", "absolute"])
def test_kf_weight_net_matches_flax(weighting_type, reference_reshape):
    obs = _obs(5, seed=2)
    net = jm.KFWeightNet(3, 2, UNITS, weighting_type=weighting_type,
                         reference_reshape=reference_reshape)
    params = net.init(jax.random.PRNGKey(2), obs)["params"]
    port = tm.KFWeightNet(3, 2, UNITS, weighting_type=weighting_type,
                          reference_reshape=reference_reshape)
    load_jax_params(port, params)
    with torch.no_grad():
        got = port(_torch(obs))
    assert got.shape == (2, 5, 3)
    _close(got, net.apply({"params": params}, obs), NET_ATOL)


@pytest.mark.parametrize("factory,in_dim", [
    ("state_layers", 3), ("control_layers", 7), ("observation_image_layers", None),
    ("observation_pos_layers", 3), ("observation_sensors_layers", 7)])
def test_layer_factories_build_the_flax_encoders(factory, in_dim):
    """Each factory of door_models/layers.py builds the port's encoder with
    the flax encoder's param names and shapes, and the same output."""
    x = np.random.default_rng(3).normal(
        size=(2, 32, 32) if in_dim is None else (2, in_dim)).astype(np.float32)
    net = getattr(jlayers, factory)(UNITS)
    params = net.init(jax.random.PRNGKey(3), x)["params"]
    port = getattr(tlayers, factory)(UNITS)
    load_jax_params(port, params)  # raises on any name or shape apart
    with torch.no_grad():
        _close(port(_torch(x)), net.apply({"params": params}, x), NET_ATOL)
    assert (tlayers.state_dim, tlayers.control_dim, tlayers.obs_pos_dim,
            tlayers.obs_sensors_dim) == (jlayers.state_dim, jlayers.control_dim,
                                         jlayers.obs_pos_dim, jlayers.obs_sensors_dim)


# --- Kalman update ------------------------------------------------------------


def _spd(r, n, d=3, scale=0.3):
    a = r.normal(size=(n, d, d)).astype(np.float32) * scale
    return (a @ a.transpose(0, 2, 1) + 0.05 * np.eye(d, dtype=np.float32)).astype(np.float32)


def test_kalman_update_matches_jax():
    r = np.random.default_rng(4)
    pred_mean = r.normal(size=(N, 3)).astype(np.float32)
    pred_cov = _spd(r, N)
    z = r.normal(size=(N, 3)).astype(np.float32)
    r_tril = np.linalg.cholesky(_spd(r, N)).astype(np.float32)
    want = jax_kalman_update(*map(jnp.asarray, (pred_mean, pred_cov, z, r_tril)))
    got = _kalman_update(*map(torch.from_numpy, (pred_mean, pred_cov, z, r_tril)))
    for g, w in zip(got, want):
        _close(g, w, ALGEBRA_ATOL)


def test_kalman_update_gives_nan_where_the_cholesky_fails():
    """A row whose S is not positive definite becomes NaN, as JAX's does,
    with no host check and no exception; the other rows are untouched."""
    r = np.random.default_rng(5)
    pred_cov = _spd(r, 2)
    pred_cov[1] = -np.eye(3, dtype=np.float32)
    args = (r.normal(size=(2, 3)).astype(np.float32), pred_cov,
            r.normal(size=(2, 3)).astype(np.float32),
            0.1 * np.broadcast_to(np.eye(3, dtype=np.float32), (2, 3, 3)).copy())
    mean, cov = _kalman_update(*map(torch.from_numpy, args))
    jmean, jcov = jax_kalman_update(*map(jnp.asarray, args))
    assert torch.isnan(mean[1]).all() and torch.isnan(cov[1]).all()
    assert np.isnan(np.asarray(jmean[1])).all()
    _close(mean[0], jmean[0], ALGEBRA_ATOL)


# --- The EKF def --------------------------------------------------------------


@pytest.fixture(scope="module")
def ekf():
    """(JAX def, its params, port def) of a door EKF at units 16."""
    jdef = JaxEKFDef(dynamics_model=jdefs.dynamics_def(units=UNITS),
                     virtual_sensor_model=jdefs.virtual_sensor_def(units=UNITS),
                     state_dim=3)
    params = numpy_params(jdef, 6)
    tdef = VirtualSensorEKFDef(dynamics_model=tdefs.dynamics_def(units=UNITS),
                               virtual_sensor_model=tdefs.virtual_sensor_def(units=UNITS),
                               state_dim=3)
    load_jax_params(tdef.module(), params)
    return jdef, params, tdef


def _belief(seed=7, n=N):
    r = np.random.default_rng(seed)
    return (r.normal(size=(n, 3)).astype(np.float32) * 0.3, _spd(r, n, scale=0.2))


@pytest.mark.parametrize("hoisted", [False, True])
def test_predict_jacobian_matches_jax_jacfwd(ekf, hoisted):
    """F (through the predicted covariance) and the predicted mean against
    JAX's jacfwd, with the control features hoisted and not."""
    jdef, params, tdef = ekf
    mean, cov = _belief()
    controls = np.random.default_rng(8).normal(size=(N, 7)).astype(np.float32)
    dyn = params["dynamics_model"]
    jcf = jdef.dynamics_model.encode_controls(dyn, controls) if hoisted else None
    want = jax.jit(lambda p, b, c, cf: jdef.predict(p, b, c, ctrl_feat=cf))(
        params, JaxBelief(jnp.asarray(mean), jnp.asarray(cov)), controls, jcf)
    with torch.no_grad():
        tcf = (tdef.dynamics_model.encode_controls(torch.from_numpy(controls))
               if hoisted else None)
        got = tdef.predict(GaussianBelief(*map(torch.from_numpy, (mean, cov))),
                           torch.from_numpy(controls), ctrl_feat=tcf)
    for g, w in zip(got, want):
        _close(g, w, ALGEBRA_ATOL)

    # F itself, against jax.jacfwd of one row's dynamics mean.
    def mean_fn(s, c):
        return jdef.dynamics_model.apply(dyn, s[None], c[None])[0][0]

    f_want = jax.vmap(jax.jacfwd(mean_fn))(jnp.asarray(mean), jnp.asarray(controls))
    # cov = I isolates F F^T + Q; with Q known, compare F F^T.
    eye = np.broadcast_to(np.eye(3, dtype=np.float32), (N, 3, 3)).copy()
    with torch.no_grad():
        _, pred_cov = tdef.predict(GaussianBelief(torch.from_numpy(mean),
                                                  torch.from_numpy(eye)),
                                   torch.from_numpy(controls), ctrl_feat=tcf)
    q = np.diag(np.square(jdefs.Q_DIAG)).astype(np.float32)
    f_want = np.asarray(f_want)
    _close(pred_cov - torch.from_numpy(q), f_want @ f_want.transpose(0, 2, 1), ALGEBRA_ATOL)


def test_predict_jacobian_is_differentiable(ekf):
    """BPTT reaches the dynamics weights through F: the gradient of a
    function of F against JAX's (second order through the sigmoid gate)."""
    jdef, params, tdef = ekf
    mean, cov = _belief(9)
    controls = np.random.default_rng(10).normal(size=(N, 7)).astype(np.float32)

    def jax_loss(dyn):
        _, pc = jdef.predict({"dynamics_model": dyn},
                             JaxBelief(jnp.asarray(mean), jnp.asarray(cov)), controls)
        return jnp.sum(pc ** 2)

    want = jax.jit(jax.grad(jax_loss))(params["dynamics_model"])
    net = tdef.dynamics_model.net
    net.zero_grad()
    with torch.enable_grad():
        _, pc = tdef.predict(GaussianBelief(*map(torch.from_numpy, (mean, cov))),
                             torch.from_numpy(controls))
        torch.sum(pc ** 2).backward()
    for name in ("shared_dense_out", "state_layers.dense"):
        path = name.split(".")
        node = want
        for p in path:
            node = node[p]
        w = np.asarray(node["kernel"]).T
        g = net.get_submodule(name).weight.grad
        np.testing.assert_allclose(g.numpy(), w, atol=1e-4 * max(1.0, np.abs(w).max()),
                                   rtol=0)
    net.zero_grad()


def test_step_and_forward_loop_match_jax(ekf):
    jdef, params, tdef = ekf
    mean, cov = _belief(11)
    obs_seq = _obs(N, seed=12, lead=(T,))
    controls = np.random.default_rng(13).normal(size=(T, N, 7)).astype(np.float32)
    jb = jdef.initialize_beliefs(params, None, jnp.asarray(mean), jnp.asarray(cov),
                                 train=False)
    final, want = jdef.forward_loop(params, jb, obs_seq, controls, None, train=False)
    tb = tdef.initialize_beliefs(torch.from_numpy(mean), torch.from_numpy(cov), train=False)
    tfinal, got = tdef.forward_loop(tb, _torch(obs_seq), torch.from_numpy(controls),
                                    train=False)
    assert not got.requires_grad
    scale = _scale(want)
    _close(got, want, LOOP_RTOL * scale)
    _close(tfinal.cov, final.cov, LOOP_RTOL * _scale(final.cov))

    # One step from the same belief.
    step_obs = {k: v[0] for k, v in obs_seq.items()}
    jnew, jest = jax.jit(lambda p, b, o, c: jdef.step(p, b, o, c, None, train=False))(
        params, jb, step_obs, controls[0])
    tnew, test_ = tdef.step(tb, _torch(step_obs), torch.from_numpy(controls[0]),
                            train=False)
    _close(test_, jest, ALGEBRA_ATOL)
    _close(tnew.cov, jnew.cov, ALGEBRA_ATOL)
    _close(got[0], jest, ALGEBRA_ATOL)


def test_forward_loop_without_control_hoist_is_the_same(ekf):
    """hoist_ctrl=False runs the control encoder inside the loop: the same
    rows, the same result."""
    import dataclasses

    _, _, tdef = ekf
    mean, cov = _belief(14)
    obs_seq = _torch(_obs(N, seed=15, lead=(3,)))
    controls = torch.from_numpy(np.random.default_rng(16).normal(size=(3, N, 7))
                                .astype(np.float32))
    belief = GaussianBelief(*map(torch.from_numpy, (mean, cov)))
    _, hoisted = tdef.forward_loop(belief, obs_seq, controls, train=False)
    _, plain = dataclasses.replace(tdef, hoist_ctrl=False).forward_loop(
        belief, obs_seq, controls, train=False)
    torch.testing.assert_close(plain, hoisted, atol=ALGEBRA_ATOL, rtol=0)


def test_measurement_initialize_beliefs_matches_jax(ekf):
    jdef, params, tdef = ekf
    obs = _obs(N, seed=17)
    want = jdef.measurement_initialize_beliefs(params, obs)
    with torch.no_grad():
        got = tdef.measurement_initialize_beliefs(_torch(obs))
    _close(got.mean, want.mean, NET_ATOL)
    _close(got.cov, want.cov, NET_ATOL)
