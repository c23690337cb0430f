"""The Kalman-filter fusion of the port against the JAX package on the CPU:
``CrossmodalKFDef``, ``UnimodalKFDef`` and the two measurement-fusion
sensors (``CrossmodalVirtualSensorDef``, ``UnimodalVirtualSensorDef``) under
an EKF, each for every enabled pattern; the crossmodal KF's blackout
override; the unimodal KF's per-child beliefs; the numpy oracle of
``tests/test_crossmodal_kf_oracle.py`` run on the port; the facade's KF
surface; and the five door KF classes' parameter trees at full width.

Small widths (units 16 through the ``_defs`` builders), N = 4, T = 6, fp32
on both sides, the same numpy inputs and weights (``load_jax_params``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from crossmodal.door_models import _defs as jdefs
from crossmodal.tasks import DoorTask as JaxDoorTask
from multimodalfilter_tpu import filtering as jf
from multimodalfilter_tpu.filtering import wrappers as jwrappers
from multimodalfilter_tpu_torch import filtering as tf
from multimodalfilter_tpu_torch.crossmodal import door_models as tdoor
from multimodalfilter_tpu_torch.crossmodal.door_models import _defs as tdefs
from multimodalfilter_tpu_torch.crossmodal.tasks import DoorTask
from multimodalfilter_tpu_torch.experiments import Buddy
from multimodalfilter_tpu_torch.filtering.wrappers import freeze_module
from multimodalfilter_tpu_torch.types import GaussianBelief
from multimodalfilter_tpu_torch.weights import load_jax_params, params_from_jax

UNITS, N, T = 16, 4, 6
PATTERNS = [(True, True), (True, False), (False, True)]
# A filter step or loop of T = 6 steps: fp32 nets in two frameworks (sums in
# another order), a 3x3 Cholesky solve a child a step and, in the unimodal
# KF, two 3x3 inverses of the children's covariances (up to 1.3e-5 of scale
# after one step), carried through the recursion; relative to the values'
# scale (O(1) at these weights).
LOOP_RTOL = 1e-4
# A measurement init: the virtual sensors and the gate, no inverse.
STEP_ATOL = 1e-5
# UnimodalVirtualSensorDef with both modalities is held at these same
# limits: its "precision" 1/(scale_tril + 1e-9) puts 1e9 in every
# off-diagonal entry, beside which the diagonal 1/sigma (O(1-100)) is below
# half an fp32 ulp and rounds away, in both frameworks. The matrix it
# inverts is then 2e9 (J - I), whose condition number is 2, and its inverse,
# the fused "covariance", is 2.5e-10 (J - 2I) whatever the inputs
# (test_unimodal_virtual_sensor_covariance_is_the_rounded_constant).


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread while this module runs (the suite runs in several
    worker processes at once). Restored after the module."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _obs(n, seed, lead=()):
    r = np.random.default_rng(seed)
    return {"image": r.normal(size=lead + (n, 32, 32)).astype(np.float32),
            "gripper_pos": r.normal(size=lead + (n, 3)).astype(np.float32),
            "gripper_sensors": r.normal(size=lead + (n, 7)).astype(np.float32)}


def _torch(tree):
    if isinstance(tree, dict):
        return {k: _torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.asarray(tree))


def _scale(x):
    return max(1.0, float(np.nanmax(np.abs(np.asarray(x)))))


def _close(got, want, rtol):
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=rtol * _scale(want), rtol=0)


def _ekf(defs, virtual_sensor_model):
    jax_side = defs is jdefs
    kwargs = {"state_dim": 3}
    return (jf.VirtualSensorEKFDef if jax_side else tf.VirtualSensorEKFDef)(
        dynamics_model=defs.dynamics_def(units=UNITS),
        virtual_sensor_model=virtual_sensor_model, **kwargs)


def _sensors(defs):
    return (defs.virtual_sensor_def(units=UNITS, modalities=("image",)),
            defs.virtual_sensor_def(units=UNITS, modalities=("pos", "sensors")))


def _build(kind, defs, blackout=False):
    """One of the four fusion filters at units 16, from a package's builders."""
    jax_side = defs is jdefs
    pkg = jf if jax_side else tf
    state = {"state_dim": 3} if jax_side else {}
    if kind == "cmkf":
        return pkg.CrossmodalKFDef(
            filter_models=tuple(_ekf(defs, vs) for vs in _sensors(defs)),
            crossmodal_weight_model=defs.kf_weight_def(units=UNITS),
            state_dim=3, know_image_blackout=blackout)
    if kind == "ukf":
        return pkg.UnimodalKFDef(filter_models=tuple(_ekf(defs, vs) for vs in _sensors(defs)),
                                 state_dim=3)
    if kind == "cmvs":
        return _ekf(defs, pkg.CrossmodalVirtualSensorDef(
            virtual_sensor_model=_sensors(defs),
            crossmodal_weight_model=defs.kf_weight_def(units=UNITS), **state))
    return _ekf(defs, pkg.UnimodalVirtualSensorDef(virtual_sensor_model=_sensors(defs),
                                                    **state))


def numpy_params(definition, seed):
    """A JAX def's param tree, its shapes traced (eval_shape) and its values
    drawn from numpy: kernels with variance 1/fan_in, biases 0.1 sigma (so
    that every bias is exercised)."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        if path[-1].key == "bias":
            return (0.1 * rng.normal(size=leaf.shape)).astype(np.float32)
        fan_in = int(np.prod(leaf.shape[:-1]))
        return (rng.normal(size=leaf.shape) / np.sqrt(fan_in)).astype(np.float32)

    shapes = jax.eval_shape(definition.init, jax.random.PRNGKey(0))
    return jax.tree_util.tree_map_with_path(draw, shapes)


@pytest.fixture(scope="module")
def filters():
    """kind -> (JAX def, params, port def), the same weights."""
    out = {}
    for i, kind in enumerate(("cmkf", "ukf", "cmvs", "uvs")):
        jdef = _build(kind, jdefs)
        params = numpy_params(jdef, 20 + i)
        tdef = _build(kind, tdefs)
        load_jax_params(tdef.module(), params)
        out[kind] = (jdef, params, tdef)
    return out


def _inputs(seed, t=T, n=N):
    r = np.random.default_rng(seed)
    a = r.normal(size=(n, 3, 3)).astype(np.float32) * 0.2
    cov = (a @ a.transpose(0, 2, 1) + 0.05 * np.eye(3, dtype=np.float32)).astype(np.float32)
    return ((0.3 * r.normal(size=(n, 3))).astype(np.float32), cov,
            _obs(n, seed + 1, lead=(t,)),
            r.normal(size=(t, n, 7)).astype(np.float32))


def _beliefs(jdef, params, tdef, mean, cov):
    jb = jdef.initialize_beliefs(params, None, jnp.asarray(mean), jnp.asarray(cov),
                                 train=False)
    tb = tdef.initialize_beliefs(torch.from_numpy(mean), torch.from_numpy(cov), train=False)
    return jb, tb


def _flat_beliefs(belief):
    """A belief (or a tuple of them) as a list of arrays."""
    if isinstance(belief, tuple) and not hasattr(belief, "mean"):
        return [x for b in belief for x in b]
    return list(belief)


@pytest.mark.parametrize("enabled", PATTERNS)
@pytest.mark.parametrize("kind", ["cmkf", "ukf", "cmvs", "uvs"])
def test_forward_loop_and_step_match_jax(filters, kind, enabled):
    """Every fusion filter under every enabled pattern: the loop's estimates
    at every step and its final belief, then one step from the initial
    belief, against JAX. The loop stays finite (a comparison of NaNs would
    hold nothing)."""
    jdef, params, tdef = filters[kind]
    mean, cov, obs_seq, controls = _inputs(30)
    jb, tb = _beliefs(jdef, params, tdef, mean, cov)
    jfinal, want = jdef.forward_loop(params, jb, obs_seq, controls, None, train=False,
                                     enabled=enabled)
    tfinal, got = tdef.forward_loop(tb, _torch(obs_seq), torch.from_numpy(controls),
                                    train=False, enabled=enabled)
    assert np.isfinite(np.asarray(want)).all() and torch.isfinite(got).all()
    _close(got, want, LOOP_RTOL)
    for g, w in zip(_flat_beliefs(tfinal), _flat_beliefs(jfinal)):
        _close(g, w, LOOP_RTOL)

    # One step from the initial belief: against JAX's step with every
    # modality on, and against the port loop's first step otherwise (JAX's
    # loop and step agree bitwise; a JAX step per pattern would add a
    # compile each).
    step_obs = {k: v[0] for k, v in obs_seq.items()}
    tnew, test_ = tdef.step(tb, _torch(step_obs), torch.from_numpy(controls[0]),
                            train=False, enabled=enabled)
    if all(enabled):
        jnew, jest = jax.jit(lambda p, b, o, c: jdef.step(p, b, o, c, None, train=False))(
            params, jb, step_obs, controls[0])
        _close(test_, jest, LOOP_RTOL)
        for g, w in zip(_flat_beliefs(tnew), _flat_beliefs(jnew)):
            _close(g, w, LOOP_RTOL)
    torch.testing.assert_close(test_, got[0], atol=1e-6, rtol=0)


@pytest.mark.parametrize("enabled", PATTERNS)
@pytest.mark.parametrize("kind", ["cmkf", "ukf", "cmvs", "uvs"])
def test_measurement_initialize_beliefs_matches_jax(filters, kind, enabled):
    """The fusion KFs take the enabled modalities; the EKF over a fusion
    sensor takes none (its sensor runs every modality), as the JAX facade's
    TypeError fallback calls it."""
    jdef, params, tdef = filters[kind]
    obs = _obs(N, 40)
    kwargs = {"enabled": enabled} if kind in ("cmkf", "ukf") else {}
    want = jdef.measurement_initialize_beliefs(params, obs, **kwargs)
    with torch.no_grad():
        got = tdef.measurement_initialize_beliefs(_torch(obs), **kwargs)
    for g, w in zip(_flat_beliefs(got), _flat_beliefs(want)):
        _close(g, w, STEP_ATOL)


def test_unimodal_kf_keeps_a_disabled_childs_belief(filters):
    """The unimodal KF's children carry independent beliefs: a disabled
    child's is returned as it came in, and the fused estimate is the
    enabled child's own."""
    jdef, params, tdef = filters["ukf"]
    mean, cov, obs_seq, controls = _inputs(50, t=3)
    _, tb = _beliefs(jdef, params, tdef, mean, cov)
    final, est = tdef.forward_loop(tb, _torch(obs_seq), torch.from_numpy(controls),
                                   train=False, enabled=(False, True))
    assert final[0].mean is tb[0].mean and final[0].cov is tb[0].cov
    child_final, child_est = tdef.filter_models[1].forward_loop(
        tb[1], _torch(obs_seq), torch.from_numpy(controls), train=False)
    torch.testing.assert_close(est, child_est, atol=0, rtol=0)
    torch.testing.assert_close(final[1].cov, child_final.cov, atol=0, rtol=0)


def test_crossmodal_kf_blackout_override_matches_jax(filters):
    """know_image_blackout: on all-zero image frames the weights become
    (1e-9, 1 - 1e-9), elsewhere the gate's; the loop against JAX's with two
    frames blacked out for some trajectories, and the blacked-out step's
    estimate equal to the force child's from the same belief."""
    jdef, params, tdef = filters["cmkf"]
    jdef = dataclasses.replace(jdef, know_image_blackout=True)
    tdef = dataclasses.replace(tdef, know_image_blackout=True)
    mean, cov, obs_seq, controls = _inputs(60)
    obs_seq["image"][1, :2] = 0.0
    obs_seq["image"][4, 1:3] = 0.0
    jb, tb = _beliefs(jdef, params, tdef, mean, cov)
    _, want = jdef.forward_loop(params, jb, obs_seq, controls, None, train=False)
    _, got = tdef.forward_loop(tb, _torch(obs_seq), torch.from_numpy(controls), train=False)
    _close(got, want, LOOP_RTOL)

    step_obs = _torch({k: v[1] for k, v in obs_seq.items()})
    _, est = tdef.step(tb, step_obs, torch.from_numpy(controls[1]), train=False)
    _, force = tdef.filter_models[1].step(tb, step_obs, torch.from_numpy(controls[1]),
                                          train=False)
    torch.testing.assert_close(est[:2], force[:2], atol=1e-6, rtol=1e-5)
    assert not torch.allclose(est[2:], force[2:], atol=1e-4)


def test_unimodal_virtual_sensor_returns_a_covariance_with_one_modality(filters):
    """With one modality enabled the unimodal sensor returns tril @ tril^T,
    a covariance, in the scale_tril slot (the reference's literal return)."""
    _, _, tdef = filters["uvs"]
    fusion = tdef.virtual_sensor_model
    obs = _torch(_obs(N, 70))
    with torch.no_grad():
        z, out = fusion.apply(obs, enabled=(True, False))
        z0, tril0 = fusion.virtual_sensor_model[0].apply(obs)
    torch.testing.assert_close(z, z0, atol=0, rtol=0)
    torch.testing.assert_close(out, tril0 @ tril0.mT, atol=0, rtol=0)


def test_unimodal_virtual_sensor_covariance_is_the_rounded_constant(filters):
    """With both modalities on, the unimodal sensor's fused "covariance" is
    2.5e-10 (J - 2I) in fp32 whatever the observations, bit for bit as in
    JAX: the precision's diagonal rounds away beside its 2e9 off-diagonal
    entries. The matrix it inverts is well conditioned (2, in fp64 of the
    rounded fp32 sum), so both frameworks invert it alike."""
    jdef, params, tdef = filters["uvs"]
    fusion = tdef.virtual_sensor_model
    obs = _obs(N, 80)
    with torch.no_grad():
        _, cov = fusion.apply(_torch(obs))
        trils = torch.stack([vs.apply(_torch(obs))[1] for vs in fusion.virtual_sensor_model])
    _, want = jdef.virtual_sensor_model.apply(params["virtual_sensor_model"], obs)
    np.testing.assert_array_equal(cov.numpy(), np.asarray(want))
    constant = 2.5e-10 * (np.ones((3, 3)) - 2 * np.eye(3))
    np.testing.assert_allclose(cov.numpy(), np.broadcast_to(constant, (N, 3, 3)), rtol=1e-6)
    summed = ((1.0 / (trils + 1e-9)).sum(dim=0) + 1e-9).double()
    np.testing.assert_allclose(torch.linalg.cond(summed).numpy(), 2.0, rtol=1e-6)


# --- The numpy oracle of tests/test_crossmodal_kf_oracle.py ------------------

D, C = 2, 2
A = np.array([[0.95, 0.05], [0.0, 0.9]], dtype=np.float32)
B = np.eye(2, dtype=np.float32) * 0.3
Q_DIAG = np.array([0.04, 0.09], dtype=np.float32)
R_DIAGS = {"y0": np.array([0.10, 0.20], np.float32), "y1": np.array([0.30, 0.05], np.float32)}
WEIGHTS = np.array([[0.7, 0.4], [0.3, 0.6]], dtype=np.float32)  # (K, D)


class _LinearDynamics(nn.Module):
    def forward(self, states, controls):
        new = states @ torch.from_numpy(A).T + controls @ torch.from_numpy(B).T
        return new, torch.diag(torch.from_numpy(np.sqrt(Q_DIAG))).expand(
            states.shape[:-1] + (D, D))


class _LinearSensor(nn.Module):
    def __init__(self, key):
        super().__init__()
        self.key = key

    def forward(self, observations):
        y = observations[self.key]
        return y, torch.diag(torch.from_numpy(np.sqrt(R_DIAGS[self.key]))).expand(
            y.shape[:-1] + (D, D))


class _FixedGate(nn.Module):
    def forward(self, observations):
        n = observations["y0"].shape[0]
        return torch.from_numpy(WEIGHTS)[:, None, :].expand(2, n, D)


def _numpy_oracle(mean, cov, obs_seq, controls):
    q = np.diag(Q_DIAG)
    estimates = []
    for t in range(controls.shape[0]):
        child_means, child_covs = [], []
        for key in ("y0", "y1"):
            pred_mean = mean @ A.T + controls[t] @ B.T
            pred_cov = A @ cov[0] @ A.T + q  # the same covariance in every row
            gain = pred_cov @ np.linalg.inv(pred_cov + np.diag(R_DIAGS[key]))
            child_means.append(pred_mean + (obs_seq[key][t] - pred_mean) @ gain.T)
            child_covs.append((np.eye(D) - gain) @ pred_cov)
        w = WEIGHTS[:, None, :]
        mean = (w / (w.sum(axis=0) + 1e-9) * np.stack(child_means)).sum(axis=0)
        fused = sum(np.outer(WEIGHTS[k], WEIGHTS[k]) * child_covs[k] for k in range(2))
        cov = np.broadcast_to(fused, cov.shape).copy()
        estimates.append(mean.copy())
    return np.stack(estimates)


def test_crossmodal_kf_matches_numpy_oracle():
    """Two linear virtual-sensor EKFs, fixed per-state-dim weights, the fused
    belief written back as both children's prior; the oracle's limits."""
    n, t = 3, 6
    r = np.random.default_rng(0)
    obs_seq = {k: r.normal(size=(t, n, D)).astype(np.float32) for k in ("y0", "y1")}
    controls = r.normal(size=(t, n, C)).astype(np.float32)
    mean0 = r.normal(size=(n, D)).astype(np.float32)
    cov0 = np.broadcast_to(0.2 * np.eye(D, dtype=np.float32), (n, D, D)).copy()
    defn = tf.CrossmodalKFDef(
        filter_models=tuple(
            tf.VirtualSensorEKFDef(dynamics_model=tf.DynamicsDef(_LinearDynamics()),
                                   virtual_sensor_model=tf.VirtualSensorDef(_LinearSensor(k)),
                                   state_dim=D)
            for k in ("y0", "y1")),
        crossmodal_weight_model=tf.KFWeightDef(_FixedGate()), state_dim=D)
    belief = defn.initialize_beliefs(torch.from_numpy(mean0), torch.from_numpy(cov0),
                                     train=False)
    _, estimates = defn.forward_loop(belief, _torch(obs_seq), torch.from_numpy(controls),
                                     train=False)
    np.testing.assert_allclose(estimates.numpy(), _numpy_oracle(mean0, cov0, obs_seq, controls),
                               rtol=2e-4, atol=2e-5)


# --- The facade's KF surface ---------------------------------------------------


def test_facade_enabled_count_blackout_and_handles(tmp_path):
    model = tdoor.DoorCrossmodalKalmanFilter(device="cpu", seed=1)
    assert model.enabled_models == [True, True]
    model.enabled_models = [True, False]
    assert model.filter_models[0].enabled_models == [True, False]
    assert tdoor.DoorKalmanFilter(device="cpu").enabled_models is None
    assert tdoor.DoorMeasurementUnimodalKalmanFilter(device="cpu").enabled_models == [True] * 2

    # know_image_blackout is the def's own flag; the networks are kept.
    params = model.params
    assert not model.know_image_blackout
    model.know_image_blackout = True
    assert model.know_image_blackout and model.definition.know_image_blackout
    assert model.params is params
    assert model.definition.filter_models[0].dynamics_model.net is \
        model.params.filter_models["0"].dynamics_model

    # Handles resolve to the flax paths; freezing a tuple field freezes its path.
    dyn = model.filter_models[0].dynamics_model
    assert dyn.path == "filter_models.0.dynamics_model"
    assert dyn.params is model.params.get_submodule("filter_models.0.dynamics_model")
    freeze_module(model.filter_models)
    freeze_module(model.crossmodal_weight_model)
    assert model.frozen_paths == {"filter_models", "crossmodal_weight_model"}

    # Checkpoint surgery from child 0's dynamics to child 1's.
    buddy = Buddy("kf", model, checkpoint_dir=str(tmp_path / "ckpt"),
                  metadata_dir=str(tmp_path / "meta"), log_dir=str(tmp_path / "logs"),
                  verbose=False)
    buddy.save_checkpoint("phase0")
    child0 = model.params.get_submodule("filter_models.0.dynamics_model").state_dict()
    child1 = model.params.get_submodule("filter_models.1.dynamics_model")
    assert not torch.equal(child0["shared_dense_out.weight"],
                           child1.state_dict()["shared_dense_out.weight"])
    buddy.load_checkpoint_module(source="filter_models.0.dynamics_model",
                                 target="filter_models.1.dynamics_model", label="phase0")
    for key, value in child1.state_dict().items():
        assert torch.equal(value, child0[key]), key


def test_facade_measurement_init_and_covariance():
    """measurement_initialize_beliefs through the facade (under the enabled
    modalities for a fusion KF) and state_covariance_estimate; a forward
    step keeps a Gaussian belief."""
    model = tdoor.DoorCrossmodalKalmanFilter(device="cpu", seed=2)
    model.eval()
    obs = _obs(N, 90)
    model.enabled_models = [False, True]
    model.measurement_initialize_beliefs(obs)
    want = model.definition.measurement_initialize_beliefs(_torch(obs),
                                                           enabled=(False, True))
    assert isinstance(model.belief, GaussianBelief) and not model.belief.cov.requires_grad
    torch.testing.assert_close(model.belief.mean, want.mean)
    assert model.state_covariance_estimate is model.belief.cov
    assert model.weighted_covariances is model.belief.cov
    est = model.forward(observations=obs, controls=np.zeros((N, 7), np.float32))
    assert est.shape == (N, 3) and model.state_covariance_estimate.shape == (N, 3, 3)

    ukf = tdoor.DoorUnimodalKalmanFilter(device="cpu")
    ukf.initialize_beliefs(mean=np.zeros((N, 3), np.float32),
                           covariance=np.tile(np.eye(3, dtype=np.float32), (N, 1, 1)))
    assert isinstance(ukf.belief, tuple) and len(ukf.belief) == 2
    assert ukf.state_covariance_estimate is None
    with pytest.raises(AttributeError, match="measurement initialization"):
        tdoor.DoorParticleFilter(device="cpu").measurement_initialize_beliefs(obs)


KF_TYPES = ["DoorCrossmodalKalmanFilter", "DoorKalmanFilter",
            "DoorMeasurementCrossmodalKalmanFilter", "DoorMeasurementUnimodalKalmanFilter",
            "DoorUnimodalKalmanFilter"]


@pytest.fixture(scope="module")
def jax_kf_models():
    """The JAX door KF models at full width, their init traced (eval_shape)
    rather than compiled."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jwrappers.jax, "jit", lambda fn: lambda *a: jax.eval_shape(fn, *a))
        return {name: JaxDoorTask.model_types[name]() for name in KF_TYPES}


@pytest.mark.parametrize("name", KF_TYPES)
def test_kf_class_parameter_tree_matches_jax(name, jax_kf_models):
    """Every leaf of the JAX model's param tree has its parameter in the
    port's model, of the same shape, and nothing is left over; the counts
    and the enabled flags agree."""
    jm = jax_kf_models[name]
    tm = DoorTask.model_types[name](device="cpu")
    tree = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), jm.params)
    want = params_from_jax(tree)
    got = tm.params.state_dict()
    assert sorted(got) == sorted(want)
    assert all(got[k].shape == want[k].shape for k in want)
    assert tm.num_parameters() == jm.num_parameters()
    assert tm.enabled_models == jm.enabled_models
