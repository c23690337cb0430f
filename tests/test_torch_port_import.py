"""Reference-checkpoint import (``experiments/torch_import.py``,
``Buddy.load_torch_checkpoint``) against the JAX package's import on the CPU.

Torch modules built with the reference's module structure (nn.Sequential
stacks at the indices of the reference's crossmodal/door_models and
push_models; a copy of those in ``tests/test_torch_import.py``, which is not
imported: it turns autograd off when imported) give one state dict per case.
It goes through the JAX package's converter into the JAX def and through the
port's converter into the port's def of the same structure, and the two
defs' outputs agree within 1e-5 of their scale: the same fp32 weights, the
nets' sums in other orders. The cases are those of
``tests/test_torch_import.py``: the plain PF, the virtual sensor (flatten and
spanning pools), the crossmodal PF, the crossmodal KF and the KF gate with
``reference_reshape``; and ``Buddy.load_torch_checkpoint`` on a saved file.
The nets at units 64, N <= 4.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as nn

from multimodalfilter_tpu import filtering as jf
from multimodalfilter_tpu import models as jmodels
from multimodalfilter_tpu.experiments.torch_import import (
    convert_filter_state_dict as jax_convert,
)
from multimodalfilter_tpu.experiments.torch_import import convert_kf_weight as jax_convert_gate
from multimodalfilter_tpu_torch import filtering as tf
from multimodalfilter_tpu_torch import models as tmodels
from multimodalfilter_tpu_torch.crossmodal import door_models as tdoor
from multimodalfilter_tpu_torch.experiments import Buddy
from multimodalfilter_tpu_torch.experiments.torch_import import (
    convert_filter_state_dict,
    convert_kf_weight,
)

UNITS = 64
RTOL = 1e-5
Q = (0.1, 0.1, 0.1)
MODS = ("image", "pos", "sensors")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread while this module runs (the suite runs in several
    worker processes at once). Restored after the module."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# -- the reference's module structure -----------------------------------------


class Resblock(nn.Module):
    """fannypack-style residual block (block1/block2 children)."""

    def __init__(self, units):
        super().__init__()
        self.block1 = nn.Linear(units, units)
        self.block2 = nn.Linear(units, units)


class ConvResblock(nn.Module):
    def __init__(self, ch):
        super().__init__()
        self.block1 = nn.Conv2d(ch, ch, 3, padding=1)
        self.block2 = nn.Conv2d(ch, ch, 3, padding=1)


def mlp_encoder(in_dim):
    # Reference layers.py:20-24: Sequential(Linear, ReLU, resblock).
    return nn.Sequential(nn.Linear(in_dim, UNITS), nn.ReLU(), Resblock(UNITS))


class DualSpanningAvgPool(nn.Module):
    # Reference push layers.py:43-65 (no parameters).
    pass


def image_encoder(spanning=False):
    # Reference door layers.py:52-63 / push layers.py:77-104.
    last = ([nn.Conv2d(16, 2, 3, padding=1), DualSpanningAvgPool(), nn.Linear(64, UNITS)]
            if spanning else
            [nn.Conv2d(16, 8, 3, padding=1), nn.Flatten(), nn.Linear(8192, UNITS)])
    return nn.Sequential(nn.Conv2d(1, 32, 5, padding=2), nn.ReLU(), ConvResblock(32),
                         nn.Conv2d(32, 16, 3, padding=1), nn.ReLU(), *last, nn.ReLU(),
                         Resblock(UNITS))


class Observations(nn.Module):
    def __init__(self, spanning=False, modalities=MODS):
        super().__init__()
        if "image" in modalities:
            self.observation_image_layers = image_encoder(spanning)
        if "pos" in modalities:
            self.observation_pos_layers = mlp_encoder(3)
        if "sensors" in modalities:
            self.observation_sensors_layers = mlp_encoder(7)


class TorchDynamics(nn.Module):
    # Reference dynamics.py:26-34.
    def __init__(self, state_dim=3):
        super().__init__()
        self.state_layers = mlp_encoder(state_dim)
        self.control_layers = mlp_encoder(7)
        self.shared_layers = nn.Sequential(
            nn.Linear(UNITS * 2, UNITS), Resblock(UNITS), Resblock(UNITS),
            Resblock(UNITS), nn.Linear(UNITS, state_dim + 1))


class TorchMeasurement(Observations):
    # Reference pf.py:43-59 (all modalities, or a subset).
    def __init__(self, state_dim=3, modalities=MODS):
        super().__init__(modalities=modalities)
        self.state_layers = mlp_encoder(state_dim)
        self.shared_layers = nn.Sequential(
            nn.Linear(UNITS * (len(modalities) + 1), UNITS), nn.ReLU(), Resblock(UNITS),
            Resblock(UNITS), nn.Linear(UNITS, 1))


class TorchVirtualSensor(Observations):
    # Reference kf.py:56-78 (all modalities; optionally the spanning pools).
    def __init__(self, state_dim=3, spanning=False):
        super().__init__(spanning)
        self.shared_layers = nn.Sequential(
            nn.Linear(UNITS * 3, UNITS * 2), nn.ReLU(), Resblock(UNITS * 2),
            Resblock(UNITS * 2))

        def head():
            return nn.Sequential(nn.Linear(UNITS, state_dim), nn.ReLU(),
                                 Resblock(state_dim), nn.Linear(state_dim, state_dim))

        self.z_layer = head()
        self.r_layer = head()


class TorchPFGate(Observations):
    # Reference door crossmodal_pf.py:64-72 (3 fusion resblocks).
    def __init__(self):
        super().__init__()
        self.fusion_layers = nn.Sequential(
            nn.Linear(UNITS * 3, UNITS), nn.ReLU(), Resblock(UNITS), Resblock(UNITS),
            Resblock(UNITS), nn.Linear(UNITS, 2))


class TorchKFGate(Observations):
    # Reference crossmodal_kf.py:108-123 (sigmoid weighting).
    def __init__(self, state_dim=3):
        super().__init__()
        self.fusion_layers = nn.Sequential(
            nn.Linear(UNITS * 3, UNITS), nn.ReLU(), Resblock(UNITS),
            nn.Linear(UNITS, 2 * state_dim), nn.Sigmoid())


def _seeded(module, seed):
    """`module` with weights drawn from numpy (the same on every torch
    version): uniform of variance 1/fan_in, biases 0.1 sigma."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, p in module.named_parameters():
            if name.endswith("bias"):
                p.copy_(torch.from_numpy(0.1 * rng.normal(size=p.shape).astype(np.float32)))
            else:
                limit = np.sqrt(3.0 / p[0].numel())
                p.copy_(torch.from_numpy(
                    rng.uniform(-limit, limit, size=p.shape).astype(np.float32)))
    return module


def _prefixed(prefix, module):
    return {f"{prefix}.{k}": v for k, v in module.state_dict().items()}


# -- the defs of each package ----------------------------------------------------


def _jax_dyn():
    return jf.DynamicsDef(jmodels.DynamicsNet(state_dim=3, q_scale_tril_diag=Q, units=UNITS),
                          state_dim=3)


def _port_dyn():
    return tf.DynamicsDef(tmodels.DynamicsNet(state_dim=3, q_scale_tril_diag=Q, units=UNITS))


def _jax_mm():
    return jf.MeasurementDef(jmodels.LogLikelihoodNet(3, MODS, UNITS), state_dim=3)


def _port_mm():
    return tf.MeasurementDef(tmodels.LogLikelihoodNet(3, MODS, UNITS))


def _jax_vs(spanning=False):
    return jf.VirtualSensorDef(jmodels.VirtualSensorNet(
        3, MODS, UNITS, add_R_noise=1e-6, spanning_avg_pool=spanning), state_dim=3)


def _port_vs(spanning=False):
    return tf.VirtualSensorDef(tmodels.VirtualSensorNet(
        3, MODS, UNITS, add_R_noise=1e-6, spanning_avg_pool=spanning))


def _port_load(defn, state_dict):
    """The port's import of `state_dict` into `defn`'s parameters (every
    parameter filled, nothing left over)."""
    defn.module().load_state_dict(convert_filter_state_dict(state_dict, defn), strict=True)
    return defn


def _obs(n=2, seed=0):
    rng = np.random.default_rng(seed)
    return {"image": rng.normal(size=(n, 32, 32)).astype(np.float32),
            "gripper_pos": rng.normal(size=(n, 3)).astype(np.float32),
            "gripper_sensors": rng.normal(size=(n, 7)).astype(np.float32)}


def _t(x):
    return {k: torch.from_numpy(v) for k, v in x.items()} if isinstance(x, dict) \
        else torch.from_numpy(x)


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().numpy(), want,
                               atol=RTOL * max(1.0, float(np.abs(want).max())), rtol=0)


# -- the cases ---------------------------------------------------------------------


def test_import_plain_pf_checkpoint():
    state_dict = {**_prefixed("dynamics_model", _seeded(TorchDynamics(), 1)),
                  **_prefixed("measurement_model", _seeded(TorchMeasurement(), 2))}
    jdefn = jf.ParticleFilterDef(dynamics_model=_jax_dyn(), measurement_model=_jax_mm(),
                                 state_dim=3)
    params = jax_convert(state_dict, jdefn)
    tdefn = _port_load(tf.ParticleFilterDef(dynamics_model=_port_dyn(),
                                            measurement_model=_port_mm(), state_dim=3),
                       state_dict)
    rng = np.random.default_rng(1)
    states = rng.normal(size=(2, 3)).astype(np.float32)
    controls = rng.normal(size=(2, 7)).astype(np.float32)
    want, _ = jdefn.dynamics_model.apply(params["dynamics_model"], jnp.asarray(states),
                                         jnp.asarray(controls))
    with torch.no_grad():
        _close(tdefn.dynamics_model.apply(_t(states), _t(controls))[0], want)
        obs = _obs()
        particles = rng.normal(size=(2, 4, 3)).astype(np.float32)
        want = jdefn.measurement_model.log_likelihoods(
            params["measurement_model"], jnp.asarray(particles),
            {k: jnp.asarray(v) for k, v in obs.items()})
        _close(tdefn.measurement_model.log_likelihoods(_t(particles), _t(obs)), want)


@pytest.mark.parametrize("spanning", [False, True], ids=["flatten", "spanning"])
def test_import_virtual_sensor_checkpoint(spanning):
    """The EKF family's virtual sensor, with the push task's dual spanning
    pools as well (their own feature order after the pools)."""
    state_dict = {**_prefixed("virtual_sensor_model",
                              _seeded(TorchVirtualSensor(spanning=spanning), 3)),
                  **_prefixed("dynamics_model", _seeded(TorchDynamics(), 4))}
    jdefn = jf.VirtualSensorEKFDef(dynamics_model=_jax_dyn(),
                                   virtual_sensor_model=_jax_vs(spanning), state_dim=3)
    params = jax_convert(state_dict, jdefn)
    tdefn = _port_load(tf.VirtualSensorEKFDef(dynamics_model=_port_dyn(),
                                              virtual_sensor_model=_port_vs(spanning),
                                              state_dim=3), state_dict)
    obs = _obs(seed=3)
    z_j, tril_j = jdefn.virtual_sensor_model.apply(
        params["virtual_sensor_model"], {k: jnp.asarray(v) for k, v in obs.items()})
    with torch.no_grad():
        z_t, tril_t = tdefn.virtual_sensor_model.apply(_t(obs))
    _close(z_t, z_j)
    _close(tril_t, tril_j)


def _crossmodal_pf_state_dict(seed=5, modalities=(MODS, MODS)):
    state_dict = _prefixed("dynamics_model", _seeded(TorchDynamics(), seed))
    for i, mods in enumerate(modalities):
        state_dict.update(_prefixed(f"measurement_model.measurement_models.{i}",
                                    _seeded(TorchMeasurement(modalities=mods), seed + 1 + i)))
    state_dict.update(_prefixed("measurement_model.crossmodal_weight_model",
                                _seeded(TorchPFGate(), seed + 3)))
    return state_dict


def test_import_crossmodal_pf_checkpoint():
    """Nested containers (measurement_model.measurement_models.{0,1} and
    crossmodal_weight_model) through the def-tree walker: the gate's
    log-weights and the fused log-likelihoods."""
    state_dict = _crossmodal_pf_state_dict()
    jdefn = jf.ParticleFilterDef(
        dynamics_model=_jax_dyn(),
        measurement_model=jf.CrossmodalPFMeasurementDef(
            measurement_models=(_jax_mm(), _jax_mm()),
            crossmodal_weight_model=jf.PFWeightDef(
                jmodels.PFWeightNet(modality_count=2, units=UNITS, num_fusion_resblocks=3)),
            state_dim=3),
        state_dim=3)
    params = jax_convert(state_dict, jdefn)
    tdefn = _port_load(tf.ParticleFilterDef(
        dynamics_model=_port_dyn(),
        measurement_model=tf.CrossmodalPFMeasurementDef(
            measurement_models=(_port_mm(), _port_mm()),
            crossmodal_weight_model=tf.PFWeightDef(
                tmodels.PFWeightNet(modality_count=2, units=UNITS, num_fusion_resblocks=3))),
        state_dim=3), state_dict)
    obs = _obs(seed=5)
    jobs = {k: jnp.asarray(v) for k, v in obs.items()}
    particles = np.random.default_rng(6).normal(size=(2, 4, 3)).astype(np.float32)
    jmm, tmm = jdefn.measurement_model, tdefn.measurement_model
    with torch.no_grad():
        _close(tmm.crossmodal_weight_model.log_weights(_t(obs)),
               jmm.crossmodal_weight_model.log_weights(
                   params["measurement_model"]["crossmodal_weight_model"], jobs))
        _close(tmm.log_likelihoods(_t(particles), _t(obs)),
               jmm.log_likelihoods(params["measurement_model"], jnp.asarray(particles), jobs))


def test_import_crossmodal_kf_checkpoint():
    """filter_models.{0,1} child EKFs and the crossmodal_weight_model: the
    gate's weights and each child's virtual sensor."""
    state_dict = {}
    for i in range(2):
        state_dict.update(_prefixed(f"filter_models.{i}.dynamics_model",
                                    _seeded(TorchDynamics(), 10 + i)))
        state_dict.update(_prefixed(f"filter_models.{i}.virtual_sensor_model",
                                    _seeded(TorchVirtualSensor(), 12 + i)))
    state_dict.update(_prefixed("crossmodal_weight_model", _seeded(TorchKFGate(), 14)))

    def jchild():
        return jf.VirtualSensorEKFDef(dynamics_model=_jax_dyn(),
                                      virtual_sensor_model=_jax_vs(), state_dim=3)

    def tchild():
        return tf.VirtualSensorEKFDef(dynamics_model=_port_dyn(),
                                      virtual_sensor_model=_port_vs(), state_dim=3)

    jdefn = jf.CrossmodalKFDef(
        filter_models=(jchild(), jchild()),
        crossmodal_weight_model=jf.KFWeightDef(
            jmodels.KFWeightNet(state_dim=3, modality_count=2, units=UNITS), state_dim=3),
        state_dim=3)
    params = jax_convert(state_dict, jdefn)
    tdefn = _port_load(tf.CrossmodalKFDef(
        filter_models=(tchild(), tchild()),
        crossmodal_weight_model=tf.KFWeightDef(
            tmodels.KFWeightNet(state_dim=3, modality_count=2, units=UNITS)),
        state_dim=3), state_dict)
    obs = _obs(seed=7)
    jobs = {k: jnp.asarray(v) for k, v in obs.items()}
    with torch.no_grad():
        _close(tdefn.crossmodal_weight_model.apply(_t(obs)),
               jdefn.crossmodal_weight_model.apply(params["crossmodal_weight_model"], jobs))
        for i in range(2):
            _close(tdefn.filter_models[i].virtual_sensor_model.apply(_t(obs))[0],
                   jdefn.filter_models[i].virtual_sensor_model.apply(
                       params["filter_models"][str(i)]["virtual_sensor_model"], jobs)[0])


def test_import_gate_reference_reshape():
    """The documented caveat: with ``reference_reshape`` the imported gate
    reproduces the reference's batch-mixing reshape at N > 1, as the JAX
    package's does; the default reshape agrees with it at N = 1 only."""
    gate = _seeded(TorchKFGate(), 15)
    sub = gate.state_dict()
    jparams = jax_convert_gate(sub)
    n = 4
    obs = _obs(n=n, seed=11)
    jobs = {k: jnp.asarray(v) for k, v in obs.items()}
    for flag in (True, False):
        jdef = jf.KFWeightDef(jmodels.KFWeightNet(state_dim=3, modality_count=2, units=UNITS,
                                                  reference_reshape=flag), state_dim=3)
        tnet = tmodels.KFWeightNet(state_dim=3, modality_count=2, units=UNITS,
                                   reference_reshape=flag)
        tnet.load_state_dict(convert_kf_weight(sub, tnet), strict=True)
        tdef = tf.KFWeightDef(tnet)
        with torch.no_grad():
            for rows in (n, 1):
                got = tdef.apply({k: v[:rows] for k, v in _t(obs).items()})
                want = jdef.apply(jparams, {k: v[:rows] for k, v in jobs.items()})
                _close(got, want)
        if not flag:  # at N > 1 the two reshapes part
            with torch.no_grad():
                faithful = tf.KFWeightDef(tmodels.KFWeightNet(
                    state_dim=3, modality_count=2, units=UNITS, reference_reshape=True))
                faithful.net.load_state_dict(tnet.state_dict())
                assert not torch.allclose(tdef.apply(_t(obs)), faithful.apply(_t(obs)),
                                          atol=1e-4)


def test_buddy_load_torch_checkpoint(tmp_path):
    """A reference checkpoint file (the fannypack layout: a dict holding
    "state_dict") imported into the port's DoorCrossmodalParticleFilter
    through Buddy: every parameter filled with the reference's tensor at its
    mapped path. The door class's likelihoods: image, and pos with sensors."""
    state_dict = _crossmodal_pf_state_dict(seed=20, modalities=(("image",),
                                                                ("pos", "sensors")))
    path = tmp_path / "reference.ckpt"
    torch.save({"state_dict": state_dict, "steps": 7}, path)
    model = tdoor.DoorCrossmodalParticleFilter(device="cpu")
    buddy = Buddy("import_test", model, checkpoint_dir=str(tmp_path / "c"),
                  metadata_dir=str(tmp_path / "m"), log_dir=str(tmp_path / "l"),
                  verbose=False)
    buddy.load_torch_checkpoint(str(path))
    got = model.params.state_dict()
    want = convert_filter_state_dict(state_dict, model.definition)
    assert sorted(got) == sorted(want)
    assert all(torch.equal(got[k], want[k]) for k in want)
    # A few mappings by hand: an index of a Sequential to its named layer.
    assert torch.equal(got["dynamics_model.shared_dense_in.weight"],
                       state_dict["dynamics_model.shared_layers.0.weight"])
    assert torch.equal(
        got["measurement_model.measurement_models.0.obs_encoders.observation_image_layers"
            ".dense.weight"],
        state_dict["measurement_model.measurement_models.0.observation_image_layers.7.weight"])
    assert torch.equal(
        got["measurement_model.crossmodal_weight_model.fusion_resblock2.block2.bias"],
        state_dict["measurement_model.crossmodal_weight_model.fusion_layers.4.block2.bias"])
