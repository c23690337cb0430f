"""The port's serving stack against the JAX package on the CPU: the folded
image-encoder tail, bf16 encoder compute in every observation net, the
serving knobs of ``StatefulFilter`` (``MMF_TPU_SERVING``, ``MMF_TPU_BF16``,
``MMF_TPU_FOLD_ENC``, ``MMF_TPU_STACK_ENC``, ``MMF_TPU_FUSED_STEP``,
``MMF_TPU_RBG``) set field by field as the JAX facade sets them, training
that strips the serving transforms, and one ``MMF_TPU_SERVING=1`` eval loop
held step by step against JAX's.

Small widths (units 16) for the nets, the door classes at full width for the
knobs and the loops; the same numpy inputs and weights on both sides
(``load_jax_params``). Tolerances:

- the fold in fp32: 2e-5 of scale, the JAX package's limit
  (``tests/test_fold_encoder.py``): the same linear map summed in another
  order; the folded weight itself 1e-6 of scale against JAX's (both exact
  constructions, the port's in float64, JAX's at Precision.HIGHEST);
- bf16: BF16_ULPS bf16 ulps of the values' scale (one bf16 ulp is 2^-7 of
  the power of two below the scale). XLA and torch round each layer to bf16
  alike (the unfolded flatten variant agrees to fp32 rounding), but the
  port applies the fold as one product where JAX sums two half-height
  products in bf16 (one more rounding, ~0.5 ulp of the features' scale),
  and XLA sums the spanning pools' 64 terms in bf16 where torch accumulates
  in fp32 (up to 3.6 ulps of scale measured); fp32 trunks carry the
  features' differences into the nets' outputs.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crossmodal import door_models as jdoor
from crossmodal.tasks import DoorTask as JaxDoorTask
from multimodalfilter_tpu import models as jm
from multimodalfilter_tpu.filtering import wrappers as jwrappers
from multimodalfilter_tpu.models.encoders import _fold_tail_weights as jax_fold
from multimodalfilter_tpu.types import ParticleBelief as JaxBelief
from multimodalfilter_tpu_torch import models as tm
from multimodalfilter_tpu_torch.crossmodal import door_models as tdoor
from multimodalfilter_tpu_torch.crossmodal.tasks import DoorTask
from multimodalfilter_tpu_torch.data.datasets import SubsequenceDataset
from multimodalfilter_tpu_torch.experiments import Buddy
from multimodalfilter_tpu_torch.models.encoders import fold_tail_weights
from multimodalfilter_tpu_torch.train import loops
from multimodalfilter_tpu_torch.types import ParticleBelief, Trajectory
from multimodalfilter_tpu_torch.utils import (
    with_compute_dtype,
    with_fold_tail,
    with_hoist_ctrl,
    with_hoist_rng,
    with_scan_unroll,
)
from multimodalfilter_tpu_torch.weights import load_jax_params

UNITS = 16
FOLD_RTOL = 2e-5
FOLD_WEIGHT_RTOL = 1e-6
BF16_ULPS = 8
KNOBS = ("MMF_TPU_SERVING", "MMF_TPU_BF16", "MMF_TPU_FOLD_ENC", "MMF_TPU_STACK_ENC",
         "MMF_TPU_FUSED_STEP", "MMF_TPU_PALLAS", "MMF_TPU_RBG")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread while this module runs (the suite runs in several
    worker processes at once). Restored after the module."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def no_knobs(monkeypatch):
    for name in KNOBS:
        monkeypatch.delenv(name, raising=False)
    return monkeypatch


def _scale(x):
    return max(1.0, float(np.abs(np.asarray(x, np.float32)).max()))


def _close(got, want, rtol):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.detach().float().numpy(), want,
                               atol=rtol * _scale(want), rtol=0)


def _bf16_close(got, want):
    want = np.asarray(want, np.float32)
    ulp = 2.0 ** (math.floor(math.log2(float(np.abs(want).max()))) - 7)
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


def _net_params(net, *args, seed=0):
    return _draw(jax.eval_shape(net.init, jax.random.PRNGKey(0), *args), seed)["params"]


def _obs(n, seed, lead=()):
    r = np.random.default_rng(seed)
    return {"image": r.normal(size=lead + (n, 32, 32)).astype(np.float32),
            "gripper_pos": r.normal(size=lead + (n, 3)).astype(np.float32),
            "gripper_sensors": r.normal(size=lead + (n, 7)).astype(np.float32)}


def _torch(tree):
    if isinstance(tree, dict):
        return {k: _torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _image_encoder(spanning, seed=1):
    images = np.random.default_rng(seed).normal(size=(6, 32, 32)).astype(np.float32)
    params = _net_params(jm.ImageEncoder(UNITS, spanning_avg_pool=spanning), images,
                         seed=seed)
    port = tm.ImageEncoder(UNITS, spanning)
    load_jax_params(port, params)
    return params, port, images


# ---------------------------------------------------------------------------
# The folded tail
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("spanning", [False, True])
def test_fold_matches_jax_and_the_unfolded_encoder(spanning):
    """The folded weight against JAX's construction (in the port's (c, h, w)
    row order), the folded encoder against JAX's and against the port's
    unfolded one."""
    params, port, images = _image_encoder(spanning)
    p = params
    w_jax, b_jax = jax_fold(p["conv3"]["kernel"], p["conv3"]["bias"], p["dense"]["kernel"],
                            p["dense"]["bias"], spanning)
    w_jax = np.asarray(w_jax).reshape(32, 32, 16, UNITS).transpose(3, 2, 0, 1)
    with torch.no_grad():
        weight, bias = fold_tail_weights(port.conv3, port.dense, spanning)
        folded = port(_torch(images), fold_tail=True)
        plain = port(_torch(images))
    assert weight.dtype == bias.dtype == torch.float32
    _close(weight, w_jax.reshape(UNITS, -1), FOLD_WEIGHT_RTOL)
    _close(bias, b_jax, FOLD_WEIGHT_RTOL)
    want = jm.ImageEncoder(UNITS, spanning_avg_pool=spanning, fold_tail=True).apply(
        {"params": params}, images)
    _close(folded, want, FOLD_RTOL)
    _close(folded, plain.numpy(), FOLD_RTOL)


def test_fold_gradients_match_the_unfolded_encoder():
    """Gradients reach conv3 and the dense through the folded weight, equal
    to the unfolded encoder's up to summation order (1e-4 of each
    parameter's scale: sums over 6 frames x 1024 pixels)."""
    _, port, images = _image_encoder(False, seed=2)
    grads = []
    for fold in (True, False):
        port.zero_grad()
        with torch.enable_grad():  # whatever the global grad mode (C1)
            port(_torch(images), fold_tail=fold).pow(2).sum().backward()
        grads.append([p.grad.clone() for p in port.parameters()])
    for g, h in zip(*grads):
        assert torch.isfinite(g).all() and g.abs().max() > 0
        torch.testing.assert_close(g, h, atol=1e-4 * float(h.abs().max()), rtol=0)


# ---------------------------------------------------------------------------
# bf16 encoders and nets
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind,fold", [("mlp", False), ("image", False), ("image", True),
                                       ("spanning", False), ("spanning", True)])
def test_bf16_encoders_match_jax(kind, fold):
    """Each layer computes in bf16 (cast input, kernel and bias, the bias
    added after the product), as flax's Dense and Conv with a dtype; the
    encoder returns bf16."""
    if kind == "mlp":
        x = np.random.default_rng(3).normal(size=(6, 7)).astype(np.float32)
        params = _net_params(jm.MLPEncoder(UNITS), x, seed=3)
        port = tm.MLPEncoder(7, UNITS)
        load_jax_params(port, params)
        want = jm.MLPEncoder(UNITS, dtype=jnp.bfloat16).apply({"params": params}, x)
        with torch.no_grad():
            got = port(_torch(x), dtype=torch.bfloat16)
    else:
        spanning = kind == "spanning"
        params, port, x = _image_encoder(spanning, seed=4)
        want = jm.ImageEncoder(UNITS, spanning_avg_pool=spanning, dtype=jnp.bfloat16,
                               fold_tail=fold).apply({"params": params}, x)
        with torch.no_grad():
            got = port(_torch(x), dtype=torch.bfloat16, fold_tail=fold)
    assert want.dtype == jnp.bfloat16 and got.dtype == torch.bfloat16
    _bf16_close(got, want)


_STATES = np.random.default_rng(5).normal(size=(4, 5, 3)).astype(np.float32)
NETS = {
    "loglik_image": (lambda: jm.LogLikelihoodNet(3, ("image",), UNITS),
                     lambda: tm.LogLikelihoodNet(3, ("image",), UNITS), True),
    "loglik_pos_sensors": (lambda: jm.LogLikelihoodNet(3, ("pos", "sensors"), UNITS),
                           lambda: tm.LogLikelihoodNet(3, ("pos", "sensors"), UNITS), True),
    "pf_weight": (lambda: jm.PFWeightNet(units=UNITS), lambda: tm.PFWeightNet(units=UNITS),
                  False),
    "virtual_sensor": (lambda: jm.VirtualSensorNet(3, ("image",), UNITS),
                       lambda: tm.VirtualSensorNet(3, ("image",), UNITS), False),
    "virtual_sensor_spanning": (
        lambda: jm.VirtualSensorNet(3, ("image",), UNITS, spanning_avg_pool=True),
        lambda: tm.VirtualSensorNet(3, ("image",), UNITS, spanning_avg_pool=True), False),
    "kf_weight": (lambda: jm.KFWeightNet(3, units=UNITS), lambda: tm.KFWeightNet(3, units=UNITS),
                  False),
}


@pytest.mark.parametrize("fold", [False, True])
@pytest.mark.parametrize("name", sorted(NETS))
def test_bf16_nets_match_jax(name, fold):
    """Every observation net under bf16 (with and without the fold): its
    outputs fp32, against JAX's; the spanning virtual sensor among them
    (the push task's, whose refusal is lifted)."""
    jax_net, port_net, takes_states = NETS[name]
    obs = _obs(4, 6)
    args = (_STATES, obs) if takes_states else (obs,)
    jnet = jax_net()
    params = _net_params(jnet, *args, seed=7)
    port = port_net()
    load_jax_params(port, params)
    want = jnet.clone(dtype=jnp.bfloat16, fold_tail=fold).apply({"params": params}, *args)
    with torch.no_grad():
        got = port(*map(_torch, args), dtype=torch.bfloat16, fold_tail=fold)
    for g, w in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        assert g.dtype == torch.float32 and w.dtype == jnp.float32
        _bf16_close(g, w)
    if takes_states:
        feats = port.encode_obs(_torch(obs), dtype=torch.bfloat16, fold_tail=fold)
        assert feats.dtype == torch.float32


def test_lstm_takes_the_fold(no_knobs):
    """The LSTM's encoders take the fold and no dtype, as JAX's
    LSTMFilterNet; its loop under the fold matches the unfolded one."""
    model = tdoor.DoorLSTMFilter(device="cpu")
    folded = with_compute_dtype(with_fold_tail(model.definition), torch.bfloat16)
    assert folded.fold_tail and not hasattr(folded, "dtype")
    obs, controls = _obs(2, 8, lead=(3,)), np.random.default_rng(9).normal(
        size=(3, 2, 7)).astype(np.float32)
    mean = torch.zeros(2, 3)
    belief = model.definition.initialize_beliefs(mean, None, train=False)
    _, want = model.definition.forward_loop(belief, _torch(obs), _torch(controls),
                                            train=False)
    _, got = folded.forward_loop(belief, _torch(obs), _torch(controls), train=False)
    _close(got, want.numpy(), FOLD_RTOL)


def test_api_parity_setters():
    """with_scan_unroll and with_hoist_rng have no field in the port and
    return the def as it is; with_hoist_ctrl sets the EKF's field."""
    model = tdoor.DoorCrossmodalKalmanFilter(device="cpu")
    defn = model.definition
    assert with_scan_unroll(defn, 4) is defn and with_hoist_rng(defn, False) is defn
    off = with_hoist_ctrl(defn, False)
    assert not any(fm.hoist_ctrl for fm in off.filter_models)
    assert all(fm.hoist_ctrl for fm in defn.filter_models)
    assert off.filter_models[0].dynamics_model is defn.filter_models[0].dynamics_model


# ---------------------------------------------------------------------------
# The serving knobs, field by field against the JAX facade
# ---------------------------------------------------------------------------


def _fields(port_def, jax_def, path=""):
    """(path, port value, JAX value) of every serving field of a port def
    tree, paired with the JAX def tree's: the dtype and the fold live on the
    JAX nets, the rest on the defs."""
    out = []
    if isinstance(port_def, tuple):
        for i, (p, j) in enumerate(zip(port_def, jax_def)):
            out += _fields(p, j, f"{path}.{i}")
        return out
    if not dataclasses.is_dataclass(port_def):
        return out
    for field in dataclasses.fields(port_def):
        value = getattr(port_def, field.name)
        where = f"{path}.{field.name}"
        if field.name in ("dtype", "fold_tail"):
            want = getattr(jax_def.net, field.name)
            out.append((where, value, None if want is None else str(jnp.dtype(want))
                        if field.name == "dtype" else want))
        elif field.name in ("stack_image_encoders", "fused_step", "stack_children",
                            "hoist_ctrl"):
            out.append((where, value, getattr(jax_def, field.name)))
        else:
            out += _fields(value, getattr(jax_def, field.name), where)
    return out


def _dtype_name(value):
    return None if value is None else str(value).replace("torch.", "")


ENVS = [
    {"MMF_TPU_SERVING": "1"},
    {"MMF_TPU_SERVING": "1", "MMF_TPU_BF16": "0"},
    {"MMF_TPU_SERVING": "1", "MMF_TPU_FOLD_ENC": "0", "MMF_TPU_STACK_ENC": "1"},
    {"MMF_TPU_STACK_ENC": "1"},
    {"MMF_TPU_FUSED_STEP": "1", "MMF_TPU_BF16": "1"},
]


@pytest.mark.parametrize("env", ENVS, ids=lambda e: "+".join(f"{k[8:]}={v}" for k, v in
                                                          e.items()))
def test_knob_matrix_matches_the_jax_facade(no_knobs, env):
    """The same environment sets the same fields on the same nets and defs
    in both facades: the crossmodal PF, the crossmodal KF and the
    measurement-fusion KF, and under the first environment the LSTM."""
    for key, value in env.items():
        no_knobs.setenv(key, value)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jwrappers.jax, "jit", lambda fn: lambda *a: jax.eval_shape(fn, *a))
        names = ["DoorCrossmodalParticleFilter", "DoorCrossmodalKalmanFilter",
                 "DoorMeasurementCrossmodalKalmanFilter"]
        if env == ENVS[0]:
            names.append("DoorLSTMFilter")
        for name in names:
            jax_def = JaxDoorTask.model_types[name]().definition
            port_def = DoorTask.model_types[name](device="cpu").definition
            fields = _fields(port_def, jax_def)
            assert fields, name
            for where, got, want in fields:
                got = _dtype_name(got) if where.endswith(".dtype") else got
                assert got == want, (name, where, got, want)


@pytest.mark.parametrize("value,accepted", [("0", True), ("off", True), ("1", False),
                                            ("rbg", False), ("unsafe_rbg", False)])
def test_rbg_knob(no_knobs, value, accepted):
    """MMF_TPU_RBG picks one of JAX's PRNG implementations; the port draws
    from torch.Generator, so it accepts the values that leave JAX's default
    and refuses the rest by name."""
    no_knobs.setenv("MMF_TPU_RBG", value)
    if accepted:
        assert tdoor.DoorUnimodalParticleFilter(device="cpu").definition is not None
    else:
        with pytest.raises(NotImplementedError, match="MMF_TPU_RBG"):
            tdoor.DoorUnimodalParticleFilter(device="cpu")


# ---------------------------------------------------------------------------
# Training strips the serving transforms
# ---------------------------------------------------------------------------


def test_training_strips_serving_transforms(no_knobs, tmp_path):
    """A model built under MMF_TPU_SERVING=1 and MMF_TPU_STACK_ENC=1 carries
    bf16, the fold and the stack in its def (which eval reads), and trains,
    by measurement pretraining and e2e, bit for bit as a plain-built model
    (JAX's test_training_strips_serving_transforms)."""
    rng = np.random.default_rng(10)
    trajs = [Trajectory(states=rng.normal(size=(12, 3)).astype(np.float32),
                        observations=_obs(12, 11 + i),
                        controls=rng.normal(size=(12, 7)).astype(np.float32))
             for i in range(2)]
    dataset = SubsequenceDataset(trajs, subsequence_length=4)
    from multimodalfilter_tpu_torch.data.datasets import ParticleFilterMeasurementDataset

    pairs = ParticleFilterMeasurementDataset(trajs, covariance=np.eye(3) * 0.1,
                                             samples_per_pair=1)

    def run(serving):
        for key in ("MMF_TPU_SERVING", "MMF_TPU_STACK_ENC"):
            if serving:
                no_knobs.setenv(key, "1")
            else:
                no_knobs.delenv(key, raising=False)
        model = tdoor.DoorCrossmodalParticleFilter(device="cpu", seed=3)
        mm = model.definition.measurement_model
        assert mm.stack_image_encoders == serving
        assert mm.measurement_models[0].fold_tail == serving
        assert mm.measurement_models[0].dtype == (torch.bfloat16 if serving else None)
        buddy = Buddy(f"strip_{serving}", model, checkpoint_dir=str(tmp_path / "c"),
                      metadata_dir=str(tmp_path / "m"), log_dir=str(tmp_path / "l"),
                      verbose=False)
        loops.train_pf_measurement(buddy, model, pairs, epochs=1, batch_size=8)
        loops.train_e2e(buddy, model, dataset, epochs=1, batch_size=4)
        return model.params.state_dict()

    plain, serving = run(False), run(True)
    for key, value in plain.items():
        assert torch.equal(value, serving[key]), key


# ---------------------------------------------------------------------------
# The serving eval loop against JAX's, step by step
# ---------------------------------------------------------------------------


def test_serving_forward_loop_matches_jax_step_by_step(no_knobs):
    """MMF_TPU_SERVING=1 on both facades (bf16 encoders and the fold; JAX's
    Pallas tail too, which resamples as its plain one): the hoisted features
    (fp32), then each step of the eval loop from a shared belief (the port's
    belief before that step) with JAX's noise and uniforms. Estimates, taken
    before resampling, within 1e-3 of scale: the features' bf16 differences
    (BF16_ULPS) through the fp32 trunks move the log-likelihoods by up to
    ~1e-3 of their scale. Resampled particles are not compared: at those
    differences a draw near a CDF step may take a neighbour."""
    no_knobs.setenv("MMF_TPU_SERVING", "1")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jwrappers.jax, "jit", lambda fn: lambda *a: jax.eval_shape(fn, *a))
        jmodel = jdoor.DoorCrossmodalParticleFilter()
    params = _draw(jmodel.params, 15)
    tmodel = tdoor.DoorCrossmodalParticleFilter(device="cpu")
    tmodel.load_jax_params(params)
    jdef = dataclasses.replace(jmodel.definition, num_particles_eval=16)
    tdef = tmodel.definition
    assert tdef.measurement_model.measurement_models[0].dtype == torch.bfloat16
    t, n, m = 2, 2, 16
    obs = _obs(n, 12, lead=(t,))
    controls = np.random.default_rng(13).normal(size=(t, n, 7)).astype(np.float32)

    flat = {k: v.reshape((t * n,) + v.shape[2:]) for k, v in obs.items()}
    want = jdef.measurement_model.encode_observations(params["measurement_model"], flat)
    with torch.no_grad():
        got = tdef.measurement_model.encode_observations(_torch(flat))
    for key in ("0", "1", "_log_weights"):
        assert got[key].dtype == torch.float32
        _bf16_close(got[key], want[key])

    one_step = jax.jit(lambda p, b, o, c, k: jdef.forward_loop(p, b, o, c, k, train=False))
    r = np.random.default_rng(14)
    belief = ParticleBelief(torch.from_numpy(r.normal(size=(n, m, 3)).astype(np.float32)),
                            torch.full((n, m), -math.log(m)))
    for s in range(t):
        key = jax.random.PRNGKey(20 + s)
        obs_s = {k: v[s:s + 1] for k, v in obs.items()}
        _, want = one_step(params, JaxBelief(jnp.asarray(belief.particles.numpy()),
                                                    jnp.asarray(belief.log_weights.numpy())),
                           obs_s, controls[s:s + 1], key)
        pairs = jax.vmap(jax.random.split)(jax.random.split(key, 1))
        eps = jax.random.normal(pairs[0, 0], (n * m, 3))[None]
        uni = jax.random.uniform(pairs[0, 1], (n, m))[None]
        with torch.no_grad():
            belief, got = tdef.forward_loop(belief, _torch(obs_s), _torch(controls[s:s + 1]),
                                            train=False, eps_seq=_torch(np.asarray(eps)),
                                            uniforms_seq=_torch(np.asarray(uni)))
        assert torch.isfinite(got).all()
        _close(got, want, 1e-3)
