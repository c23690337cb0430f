"""The port's execution transforms over several networks against the JAX
package on the CPU: the stacked image encoders (``models/stacked.py``) and
their injection into the fusion defs (``MMF_TPU_STACK_ENC``), and the KF
defs' ``stack_children`` (one vmapped chain over the children's EKF
updates).

Small widths (units 16), N <= 4, T <= 5; the same numpy inputs and weights
on both sides (``load_jax_params``). Tolerances:

- stacked against individual encoders, fp32: 2e-5 of scale, the JAX
  package's own limit (``tests/test_stacked_encoders.py``): grouped
  convolutions and batched products sum in other orders;
- bf16: BF16_ULPS bf16 ulps of the values' scale (see
  ``tests/test_torch_port_serving.py``);
- filter outputs from stacked and per-instance encoders: 1e-4 of scale, the
  JAX package's limit for the same comparison (feature rounding carried
  through the trunks and the Kalman algebra);
- ``stack_children`` against the loop over the children: 1e-4 of scale, the
  loop tests' limit (``tests/test_torch_port_kf_fusion.py``). vmap turns
  each child's products into batched ones, which the CPU may sum in another
  order: a few fp32 ulps a step (6.6e-7 of scale after 5 steps of the
  crossmodal KF here), which the unimodal KF's two 3x3 inverses of nearly
  singular sums amplify (1.5e-5); gradients through 3 steps 1e-5 of each
  parameter's scale. Against JAX's chain (which stacks too): 1e-4 of scale.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crossmodal.door_models import _defs as jdefs
from multimodalfilter_tpu import filtering as jf
from multimodalfilter_tpu.filtering.fusion import _stacked_image_injection as jax_injection
from multimodalfilter_tpu.models import ImageEncoder as JaxImageEncoder
from multimodalfilter_tpu.models.stacked import stacked_image_features as jax_stacked
from multimodalfilter_tpu.utils.precision import with_stacked_encoders as jax_with_stacked
from multimodalfilter_tpu_torch import filtering as tf
from multimodalfilter_tpu_torch.crossmodal.door_models import _defs as tdefs
from multimodalfilter_tpu_torch.filtering import fusion as tfusion
from multimodalfilter_tpu_torch.models import ImageEncoder, LogLikelihoodNet, PFWeightNet
from multimodalfilter_tpu_torch.models.stacked import stacked_image_features
from multimodalfilter_tpu_torch.utils import with_compute_dtype, with_stacked_encoders
from multimodalfilter_tpu_torch.weights import load_jax_params

UNITS = 16
STACK_RTOL = 2e-5
FILTER_RTOL = 1e-4
BF16_ULPS = 8


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread while this module runs (the suite runs in several
    worker processes at once). Restored after the module."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _scale(x):
    return max(1.0, float(np.abs(np.asarray(x, np.float32)).max()))


def _close(got, want, rtol):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy()
    np.testing.assert_allclose(got, want, atol=rtol * _scale(want), rtol=0)


def _bf16_close(got, want):
    want = np.asarray(want, np.float32)
    scale = float(np.abs(want).max())
    ulp = 2.0 ** (math.floor(math.log2(scale)) - 7)
    np.testing.assert_allclose(got.detach().float().numpy(), want,
                               atol=BF16_ULPS * ulp, rtol=0)


def _draw(shapes, seed):
    """numpy weights for a traced param tree: kernels of variance 1/fan_in,
    biases 0.1 sigma."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        if path[-1].key == "bias":
            return (0.1 * rng.normal(size=leaf.shape)).astype(np.float32)
        fan_in = int(np.prod(leaf.shape[:-1]))
        return (rng.normal(size=leaf.shape) / np.sqrt(fan_in)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _images(n, seed, lead=()):
    return np.random.default_rng(seed).normal(size=lead + (n, 32, 32)).astype(np.float32)


def _obs(n, seed, lead=()):
    r = np.random.default_rng(seed)
    return {"image": r.normal(size=lead + (n, 32, 32)).astype(np.float32),
            "gripper_pos": r.normal(size=lead + (n, 3)).astype(np.float32),
            "gripper_sensors": r.normal(size=lead + (n, 7)).astype(np.float32)}


def _torch(tree):
    if isinstance(tree, dict):
        return {k: _torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _encoders(k, spanning):
    """K JAX encoder param trees and the port's encoders holding them."""
    params, encs = [], []
    for i in range(k):
        shapes = jax.eval_shape(JaxImageEncoder(UNITS, spanning_avg_pool=spanning).init,
                                jax.random.PRNGKey(0), jnp.zeros((1, 32, 32)))
        p = _draw(shapes, 100 + i)["params"]
        enc = ImageEncoder(UNITS, spanning)
        load_jax_params(enc, p)
        params.append(p)
        encs.append(enc)
    return params, encs


# ---------------------------------------------------------------------------
# Stacked encoders
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fold", [False, True])
@pytest.mark.parametrize("spanning", [False, True])
@pytest.mark.parametrize("k", [2, 3])
def test_stacked_matches_jax_and_individual(k, spanning, fold):
    params, encs = _encoders(k, spanning)
    images = _images(3, 7)
    want = jax_stacked(params, images, spanning_avg_pool=spanning, fold_tail=fold)
    with torch.no_grad():
        got = stacked_image_features(encs, _torch(images), fold_tail=fold)
        alone = [e(_torch(images), fold_tail=fold) for e in encs]
    assert len(got) == k
    for g, w, a in zip(got, want, alone):
        assert g.shape == (3, UNITS) and g.dtype == torch.float32
        _close(g, w, STACK_RTOL)
        _close(g, a.numpy(), STACK_RTOL)


@pytest.mark.parametrize("spanning", [False, True])
def test_stacked_bf16_with_the_fold_matches_jax_and_individual(spanning):
    params, encs = _encoders(2, spanning)
    images = _images(4, 8)
    want = jax_stacked(params, images, spanning_avg_pool=spanning, dtype=jnp.bfloat16,
                       fold_tail=True)
    with torch.no_grad():
        got = stacked_image_features(encs, _torch(images), dtype=torch.bfloat16,
                                     fold_tail=True)
        alone = [e(_torch(images), dtype=torch.bfloat16, fold_tail=True) for e in encs]
    for g, w, a in zip(got, want, alone):
        assert g.dtype == torch.bfloat16
        _bf16_close(g, w)
        _bf16_close(g, a.float().numpy())


def test_stacked_gradients_match_individual():
    """The stacked pass is an execution transform of the same parameters:
    the gradients through it are the per-encoder gradients (fp32 sums in
    another order over 3 frames x 1024 pixels, relative to each parameter's
    scale)."""
    _, encs = _encoders(2, False)
    images = _torch(_images(3, 9))
    with torch.enable_grad():  # whatever the global grad mode (C1)
        sum(f.pow(2).sum() for f in stacked_image_features(encs, images)).backward()
    stacked = [p.grad.clone() for e in encs for p in e.parameters()]
    for e in encs:
        e.zero_grad()
    with torch.enable_grad():
        sum(e(images).pow(2).sum() for e in encs).backward()
    alone = [p.grad for e in encs for p in e.parameters()]
    for s, a in zip(stacked, alone):
        torch.testing.assert_close(s, a, atol=1e-4 * float(a.abs().max()), rtol=0)


def test_mixed_configs_fall_back():
    """Participants whose encoders differ in architecture or options do not
    stack, as in the JAX package; the same architecture and options do."""
    span = tf.MeasurementDef(LogLikelihoodNet(3, ("image",), UNITS, spanning_avg_pool=True))
    gate = tf.PFWeightDef(PFWeightNet(units=UNITS))
    image = tf.MeasurementDef(LogLikelihoodNet(3, ("image",), UNITS))
    no_image = tf.MeasurementDef(LogLikelihoodNet(3, ("pos", "sensors"), UNITS))
    obs = {"image": torch.zeros(2, 32, 32)}
    assert tfusion._stacked_image_injection([("0", span), ("_gate", gate)], obs) is None
    assert tfusion._stacked_image_injection(
        [("0", with_compute_dtype(image, torch.bfloat16)), ("_gate", gate)], obs) is None
    assert tfusion._stacked_image_injection([("1", no_image), ("_gate", gate)], obs) is None
    inj = tfusion._stacked_image_injection([("0", image), ("1", no_image), ("_gate", gate)],
                                           obs)
    assert set(inj) == {"0", "_gate"} and inj["0"]["_image_features"].shape == (2, UNITS)

    from multimodalfilter_tpu.models import LogLikelihoodNet as JaxLL, PFWeightNet as JaxPFW
    assert jax_injection([("0", JaxLL(3, ("image",), units=UNITS, spanning_avg_pool=True), {}),
                          ("_gate", JaxPFW(units=UNITS), {})],
                         {"image": jnp.zeros((2, 32, 32))}) is None


# ---------------------------------------------------------------------------
# The fusion defs with stacked encoders
# ---------------------------------------------------------------------------


def _ekf(pkg, defs, vs):
    return pkg.VirtualSensorEKFDef(dynamics_model=defs.dynamics_def(units=UNITS),
                                   virtual_sensor_model=vs, state_dim=3)


def _sensors(defs):
    return (defs.virtual_sensor_def(units=UNITS, modalities=("image",)),
            defs.virtual_sensor_def(units=UNITS, modalities=("pos", "sensors")))


def _build(kind, side):
    """A fusion def at units 16 from one package's def factories."""
    pkg, defs = (jf, jdefs) if side == "jax" else (tf, tdefs)
    state = {"state_dim": 3} if side == "jax" else {}
    if kind == "cmpf":
        return pkg.CrossmodalPFMeasurementDef(
            measurement_models=(defs.measurement_def(units=UNITS, modalities=("image",)),
                                defs.measurement_def(units=UNITS,
                                                     modalities=("pos", "sensors"))),
            crossmodal_weight_model=defs.pf_weight_def(units=UNITS), **state)
    if kind == "cmkf":
        return pkg.CrossmodalKFDef(
            filter_models=tuple(_ekf(pkg, defs, vs) for vs in _sensors(defs)),
            crossmodal_weight_model=defs.kf_weight_def(units=UNITS), state_dim=3)
    if kind == "ukf":
        return pkg.UnimodalKFDef(
            filter_models=tuple(_ekf(pkg, defs, vs) for vs in _sensors(defs)), state_dim=3)
    return _ekf(pkg, defs, pkg.CrossmodalVirtualSensorDef(
        virtual_sensor_model=_sensors(defs),
        crossmodal_weight_model=defs.kf_weight_def(units=UNITS), **state))


@pytest.fixture(scope="module")
def fusion_defs():
    """kind -> (JAX def, params, port def), the same weights."""
    out = {}
    for i, kind in enumerate(("cmpf", "cmkf", "ukf", "cmvs")):
        jdef = _build(kind, "jax")
        params = _draw(jax.eval_shape(jdef.init, jax.random.PRNGKey(0)), 50 + i)
        tdef = _build(kind, "port")
        load_jax_params(tdef.module(), params)
        out[kind] = (jdef, params, tdef)
    return out


def _kf_inputs(seed, t=5, n=4):
    r = np.random.default_rng(seed)
    a = r.normal(size=(n, 3, 3)).astype(np.float32) * 0.2
    cov = (a @ a.transpose(0, 2, 1) + 0.05 * np.eye(3, dtype=np.float32)).astype(np.float32)
    return ((0.3 * r.normal(size=(n, 3))).astype(np.float32), cov,
            _obs(n, seed + 1, lead=(t,)), r.normal(size=(t, n, 7)).astype(np.float32))


def test_crossmodal_pf_measurement_stacked_matches_unstacked_and_jax(fusion_defs):
    """The image measurement model's encoder and the gate's, stacked: the
    hoisted features and the log-likelihoods."""
    jdef, params, tdef = fusion_defs["cmpf"]
    stacked = with_stacked_encoders(tdef)
    assert stacked.stack_image_encoders and not tdef.stack_image_encoders
    jstacked = jax_with_stacked(jdef)
    obs = _obs(4, 11)
    states = np.random.default_rng(12).normal(size=(4, 6, 3)).astype(np.float32)
    with torch.no_grad():
        got = stacked.log_likelihoods(_torch(states), _torch(obs))
        plain = tdef.log_likelihoods(_torch(states), _torch(obs))
        feats = stacked.encode_observations(_torch(obs))
        plain_feats = tdef.encode_observations(_torch(obs))
    _close(got, plain.numpy(), FILTER_RTOL)
    _close(got, jstacked.log_likelihoods(params, states, obs), FILTER_RTOL)
    assert feats.keys() == plain_feats.keys() == {"0", "1", "_log_weights"}
    for key in feats:
        _close(feats[key], plain_feats[key].numpy(), FILTER_RTOL)


def test_crossmodal_kf_stacked_matches_unstacked_and_jax(fusion_defs):
    """The image child's virtual-sensor encoder and the gate's, stacked, in
    the hoisted loop and in a step; a step with the image child alone has
    no gate to stack with and falls back."""
    jdef, params, tdef = fusion_defs["cmkf"]
    stacked = with_stacked_encoders(tdef)
    mean, cov, obs_seq, controls = _kf_inputs(13, t=3, n=3)
    belief = _beliefs(tdef, mean, cov)
    with torch.no_grad():
        final, got = stacked.forward_loop(belief, _torch(obs_seq), _torch(controls),
                                          train=False)
        plain_final, plain = tdef.forward_loop(belief, _torch(obs_seq), _torch(controls),
                                               train=False)
    jb = jdef.initialize_beliefs(params, None, jnp.asarray(mean), jnp.asarray(cov),
                                 train=False)
    _, want = jax_with_stacked(jdef).forward_loop(params, jb, obs_seq, controls, None,
                                                  train=False)
    _close(got, plain.numpy(), FILTER_RTOL)
    _close(final.cov, plain_final.cov.numpy(), FILTER_RTOL)
    _close(got, want, FILTER_RTOL)

    obs0 = _torch({k: v[0] for k, v in obs_seq.items()})
    for enabled in ((True, True), (True, False)):
        with torch.no_grad():
            _, step = stacked.step(belief, obs0, _torch(controls[0]), train=False,
                                   enabled=enabled)
            _, plain_step = tdef.step(belief, obs0, _torch(controls[0]), train=False,
                                      enabled=enabled)
        _close(step, plain_step.numpy(), FILTER_RTOL)


def test_measurement_crossmodal_kf_stacked_matches_unstacked(fusion_defs):
    """CrossmodalVirtualSensorDef stacks the image sensor with the gate."""
    jdef, params, tdef = fusion_defs["cmvs"]
    stacked = with_stacked_encoders(tdef)
    assert stacked.virtual_sensor_model.stack_image_encoders
    obs = _obs(4, 14)
    with torch.no_grad():
        z, tril = stacked.virtual_sensor_model.apply(_torch(obs))
        z0, tril0 = tdef.virtual_sensor_model.apply(_torch(obs))
    wz, wtril = jax_with_stacked(jdef).virtual_sensor_model.apply(
        params["virtual_sensor_model"], obs)
    _close(z, z0.numpy(), FILTER_RTOL)
    _close(tril, tril0.numpy(), FILTER_RTOL)
    _close(z, wz, FILTER_RTOL)
    _close(tril, wtril, FILTER_RTOL)


# ---------------------------------------------------------------------------
# stack_children
# ---------------------------------------------------------------------------


def _beliefs(tdef, mean, cov, train=False):
    return tdef.initialize_beliefs(_torch(mean), _torch(cov), train=train)


@pytest.mark.parametrize("hoist_ctrl", [True, False])
@pytest.mark.parametrize("kind", ["cmkf", "ukf"])
def test_stack_children_equals_the_loop_and_matches_jax(fusion_defs, kind, hoist_ctrl):
    """The vmapped chain against the loop over the children, with hoisted
    control features and with raw controls; and against JAX's chain."""
    from multimodalfilter_tpu.utils.precision import with_hoist_ctrl as jax_hoist
    from multimodalfilter_tpu_torch.utils import with_hoist_ctrl

    jdef, params, tdef = fusion_defs[kind]
    tdef, jdef = with_hoist_ctrl(tdef, hoist_ctrl), jax_hoist(jdef, hoist_ctrl)
    assert tdef.stack_children and tfusion._stackable_children(tdef, (0, 1))
    mean, cov, obs_seq, controls = _kf_inputs(15)
    args = (_torch(obs_seq), _torch(controls))
    with torch.no_grad():
        final, got = tdef.forward_loop(_beliefs(tdef, mean, cov), *args, train=False)
        loop_final, loop = dataclasses.replace(tdef, stack_children=False).forward_loop(
            _beliefs(tdef, mean, cov), *args, train=False)
    _close(got, loop.numpy(), FILTER_RTOL)
    flat = (lambda b: [x for c in b for x in c]) if kind == "ukf" else list
    for a, b in zip(flat(final), flat(loop_final)):
        _close(a, b.numpy(), FILTER_RTOL)
    jb = jdef.initialize_beliefs(params, None, jnp.asarray(mean), jnp.asarray(cov),
                                 train=False)
    _, want = jdef.forward_loop(params, jb, obs_seq, controls, None, train=False)
    _close(got, want, FILTER_RTOL)


def test_stack_children_gradients_equal_the_loop(fusion_defs):
    """BPTT through the chain reaches every child's dynamics parameters, as
    through the loop (the stacked parameters are a differentiable stack)."""
    _, _, tdef = fusion_defs["cmkf"]
    mean, cov, obs_seq, controls = _kf_inputs(16, t=3, n=2)
    module = tdef.module()
    grads = []
    for stack in (True, False):
        module.zero_grad()
        defn = dataclasses.replace(tdef, stack_children=stack)
        with torch.enable_grad():  # whatever the global grad mode (C1)
            _, est = defn.forward_loop(_beliefs(defn, mean, cov, train=True),
                                       _torch(obs_seq), _torch(controls), train=True)
            est.pow(2).sum().backward()
        grads.append({k: p.grad.clone() for k, p in module.named_parameters()
                      if "dynamics_model" in k})
    assert grads[0].keys() == grads[1].keys() and len(grads[0]) > 0
    for key, g in grads[0].items():
        assert g.abs().sum() > 0, key
        torch.testing.assert_close(g, grads[1][key], atol=1e-5 * float(g.abs().max()),
                                   rtol=0)


def test_stack_children_needs_one_dynamics_architecture():
    """Children stack by architecture, not by identity: distinct modules of
    one architecture stack; other process noise (the Brent dynamics), other
    units or other hoisting do not, and the loop runs instead."""
    def ukf(*dynamics, hoist=(True, True)):
        return tf.UnimodalKFDef(filter_models=tuple(
            tf.VirtualSensorEKFDef(dynamics_model=d, virtual_sensor_model=vs, state_dim=3,
                                   hoist_ctrl=h)
            for d, vs, h in zip(dynamics, _sensors(tdefs), hoist)), state_dim=3)

    assert tfusion._stackable_children(
        ukf(tdefs.dynamics_def(units=UNITS), tdefs.dynamics_def(units=UNITS)), (0, 1))
    for defn in (ukf(tdefs.dynamics_def(units=UNITS),
                     tdefs.dynamics_def(units=UNITS, brent=True)),
                 ukf(tdefs.dynamics_def(units=UNITS), tdefs.dynamics_def(units=32)),
                 ukf(tdefs.dynamics_def(units=UNITS), tdefs.dynamics_def(units=UNITS),
                     hoist=(True, False))):
        assert not tfusion._stackable_children(defn, (0, 1))
        mean, cov, obs_seq, controls = _kf_inputs(17, t=2, n=2)
        with torch.no_grad():
            _, est = defn.forward_loop(_beliefs(defn, mean, cov), _torch(obs_seq),
                                       _torch(controls), train=False)
        assert torch.isfinite(est).all()
    single = ukf(tdefs.dynamics_def(units=UNITS), tdefs.dynamics_def(units=UNITS))
    assert not tfusion._stackable_children(single, (1,))
    assert not tfusion._stackable_children(
        dataclasses.replace(single, stack_children=False), (0, 1))
