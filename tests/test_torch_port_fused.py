"""The port's fused eval ``forward_loop`` (B3's plain version,
``ops/fused_step.fused_forward_reference``, which the route runs on the CPU)
against the JAX package's fused kernel (``pallas_fused_step``, interpret
mode) on the CPU; the packing against JAX's; the fallback of a config B3
does not cover; and the ``MMF_TPU_*`` serving knobs of ``StatefulFilter``
(the fields each sets, against the JAX facade's).

Both sides get the same weights, the same belief, noise and uniforms, and
the same hoisted inputs: the port's ``forward_loop`` runs its encoders and
then its fused route, and the JAX side runs its fused route
(``try_fused_forward``, which its ``forward_loop`` calls with
``pallas_resample`` and ``with_fused_step``) on the port's hoisted features.
The encoders' parity with JAX is held in ``test_torch_port_nets.py`` and
``test_torch_port_pf.py``; compiling JAX's encoders here as well would take
this file far past its CPU budget. The JAX params come from the port's
modules (the inverse of ``weights.params_from_jax`` on the trunks), so no
JAX model is initialised.

Estimates are held at JAX's own fused-against-scan tolerance
(``tests/test_fused_step.py``: rtol 2e-4, atol 2e-5): both sides run the
same recursion with sums in other orders. Resampled indices could differ
where a uniform lies within TIE of a CDF entry; each test asserts that its
seed has no such draw, so no tie decides it.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crossmodal import door_models as jdoor
from multimodalfilter_tpu.filtering.fusion import CrossmodalPFMeasurementDef as JaxCrossmodal
from multimodalfilter_tpu.filtering.pf import ParticleFilterDef as JaxPFDef
from multimodalfilter_tpu.ops import pallas_fused_step as jfused
from multimodalfilter_tpu.types import ParticleBelief as JaxBelief
from multimodalfilter_tpu_torch.crossmodal import door_models as tdoor
from multimodalfilter_tpu_torch.ops import fused_step, pf_kernels
from multimodalfilter_tpu_torch.types import ParticleBelief
from multimodalfilter_tpu_torch.utils import with_fused_step

TIE = 1e-6
T, N, M = 8, 2, 50
RTOL, ATOL = 2e-4, 2e-5


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small ops on one thread each, so that a machine busy with other test
    workers does not stall them on an oversubscribed thread pool. Restored
    after the module."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _sequences(t, n, seed=0):
    r = np.random.default_rng(seed)
    obs = {
        "image": r.normal(size=(t, n, 32, 32)).astype(np.float32),
        "gripper_pos": r.normal(size=(t, n, 3)).astype(np.float32),
        "gripper_sensors": r.normal(size=(t, n, 7)).astype(np.float32),
    }
    return obs, (0.1 * r.normal(size=(t, n, 7))).astype(np.float32)


def _flax_trunk(module):
    """A module's Dense layers as a flax param tree (kernel = weight.T),
    leaving out the encoders the fused route does not read."""
    tree = {}
    for key, value in module.state_dict().items():
        if key.startswith(("obs_encoders", "control_layers")):
            continue
        *path, leaf = key.split(".")
        node = tree
        for name in path:
            node = node.setdefault(name, {})
        node["kernel" if leaf == "weight" else "bias"] = jnp.asarray(
            value.numpy().T if leaf == "weight" else value.numpy())
    return tree


def _jax_side(name):
    """JAX's def of the door model `name` (as crossmodal/door_models builds
    it) and the trunk params of the port's model, with that port model."""
    tm = getattr(tdoor, name)(device="cpu", seed=7)
    dyn = jdoor.DoorDynamicsModelBrent()
    mm = tm.definition.measurement_model
    if name == "DoorParticleFilter":
        jmm = jdoor.DoorMeasurementModel()
        mparams = _flax_trunk(mm.net)
    else:
        jmm = JaxCrossmodal(
            measurement_models=(jdoor.DoorMeasurementModel(modalities={"image"}),
                                jdoor.DoorMeasurementModel(modalities={"pos", "sensors"})),
            crossmodal_weight_model=(jdoor.DoorCrossmodalWeightModel()
                                     if mm.crossmodal_weight_model is not None else None),
            state_dim=3)
        mparams = {"measurement_models": {
            str(i): _flax_trunk(sub.net) for i, sub in enumerate(mm.measurement_models)}}
    jdefn = JaxPFDef(dynamics_model=dyn, measurement_model=jmm, state_dim=3,
                     num_particles_eval=M, pallas_resample=True, fused_step=True)
    params = {"dynamics_model": _flax_trunk(tm.definition.dynamics_model.net),
              "measurement_model": mparams}
    return jdefn, params, tm


@pytest.fixture(scope="module")
def crossmodal():
    return _jax_side("DoorCrossmodalParticleFilter")


def _run_both(jdefn, params, tm, monkeypatch, enabled=None, seed=0):
    """(JAX fused estimates, port fused estimates, per-step tie gaps)."""
    obs, controls = _sequences(T, N, seed)
    r = np.random.default_rng(seed + 1)
    particles = (0.3 * r.normal(size=(N, M, 3))).astype(np.float32)
    lw = np.full((N, M), -np.log(M), np.float32)
    eps = r.normal(size=(T, N * M, 3)).astype(np.float32)
    uni = r.uniform(size=(T, N, M)).astype(np.float32)
    tdefn = with_fused_step(dataclasses.replace(tm.definition, num_particles_eval=M))
    obs_t = {k: torch.from_numpy(v) for k, v in obs.items()}
    with torch.no_grad():
        features, ctrl_features = tdefn.encode_sequences(
            obs_t, torch.from_numpy(controls), enabled)

    def jnp_tree(x):
        return ({k: jnp.asarray(v.numpy()) for k, v in x.items()} if isinstance(x, dict)
                else jnp.asarray(x.numpy()))

    _, est_j = jax.jit(lambda p, b, f, c, e, u: jfused.try_fused_forward(
        jdefn, p, b, f, c, e, u, enabled, interpret=True))(
        params, JaxBelief(jnp.asarray(particles), jnp.asarray(lw)), jnp_tree(features),
        jnp_tree(ctrl_features), jnp.asarray(eps), jnp.asarray(uni))
    assert jfused.packing_report() is None, jfused.packing_report()

    gaps = []
    real = fused_step.pf_update_and_resample_reference

    def recording(log_weights, log_liks, parts, uniforms):
        gaps.append(float(pf_kernels.draw_gaps(log_weights, log_liks, uniforms).min()))
        return real(log_weights, log_liks, parts, uniforms)

    monkeypatch.setattr(fused_step, "pf_update_and_resample_reference", recording)
    _, est_t = tdefn.forward_loop(
        ParticleBelief(torch.from_numpy(particles), torch.from_numpy(lw)), obs_t,
        torch.from_numpy(controls), train=False, enabled=enabled,
        eps_seq=torch.from_numpy(eps), uniforms_seq=torch.from_numpy(uni),
    )
    assert fused_step.packing_report() is None, fused_step.packing_report()
    return np.asarray(est_j), est_t.numpy(), gaps


@pytest.mark.parametrize("enabled", [None, (True, False), (False, True)])
def test_crossmodal_fused_loop_matches_jax_fused_kernel(crossmodal, enabled, monkeypatch):
    """K=2 gated, and each enabled subset (K=1 under the gate)."""
    est_j, est_t, gaps = _run_both(*crossmodal, monkeypatch, enabled=enabled)
    assert len(gaps) == T and min(gaps) > TIE, gaps
    assert est_t.shape == (T, N, 3) and np.isfinite(est_t).all()
    np.testing.assert_allclose(est_t, est_j, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", ["DoorParticleFilter", "DoorUnimodalParticleFilter"])
def test_other_door_pfs_fused_loop_matches_jax(name, monkeypatch):
    """K=1 (one measurement model) and K=2 without a gate."""
    est_j, est_t, gaps = _run_both(*_jax_side(name), monkeypatch, seed=3)
    assert len(gaps) == T and min(gaps) > TIE, gaps
    np.testing.assert_allclose(est_t, est_j, rtol=RTOL, atol=ATOL)


def test_fused_loop_matches_the_per_step_path(crossmodal):
    """The slice as a whole on the CPU: the fused route against the port's
    own per-step path, same draws (both plain torch; sums in other
    orders)."""
    tm = crossmodal[2]
    defn = dataclasses.replace(tm.definition, num_particles_eval=M)
    obs, controls = _sequences(T, N, seed=9)
    g = torch.Generator().manual_seed(1)
    args = (ParticleBelief(0.3 * torch.randn(N, M, 3, generator=g),
                           torch.full((N, M), -float(np.log(M)))),
            {k: torch.from_numpy(v) for k, v in obs.items()}, torch.from_numpy(controls))
    draws = dict(eps_seq=torch.randn(T, N * M, 3, generator=g),
                 uniforms_seq=torch.rand(T, N, M, generator=g))
    _, est_a = defn.forward_loop(*args, train=False, **draws)
    belief, est_b = with_fused_step(defn).forward_loop(*args, train=False, **draws)
    assert fused_step.packing_report() is None
    assert belief.particles.shape == (N, M, 3)
    torch.testing.assert_close(est_b, est_a, rtol=RTOL, atol=ATOL)


def test_packing_matches_jax(crossmodal):
    """The port packs its own modules into what JAX's _pack_dynamics and
    _pack_measurement give, up to the transpose of the biases and the
    hoisted dense_in halves ((out, in) here, flax's (in, out) there)."""
    _, params, tm = crossmodal
    wd, bd, w_ctrl, b_dyn = fused_step._pack_dynamics(tm.definition.dynamics_model.net, 3)
    jwd, jbd, jw_ctrl, jb_dyn = jfused._pack_dynamics(params["dynamics_model"], 3)
    np.testing.assert_array_equal(wd.detach().numpy(), np.asarray(jwd))
    np.testing.assert_array_equal(bd.detach().numpy(), np.asarray(jbd).T)
    np.testing.assert_array_equal(w_ctrl.detach().numpy(), np.asarray(jw_ctrl).T)
    np.testing.assert_array_equal(b_dyn.detach().numpy(), np.asarray(jb_dyn))
    for i, sub in enumerate(tm.definition.measurement_model.measurement_models):
        wm, bm, w_obs, b_in, f = fused_step._pack_measurement(sub.net, 3)
        jwm, jbm, jw_obs, jb_in, jf = jfused._pack_measurement(
            params["measurement_model"]["measurement_models"][str(i)], 3)
        assert f == jf
        np.testing.assert_array_equal(wm.detach().numpy(), np.asarray(jwm))
        np.testing.assert_array_equal(bm.detach().numpy(), np.asarray(jbm).T)
        np.testing.assert_array_equal(w_obs.detach().numpy(), np.asarray(jw_obs).T)
        np.testing.assert_array_equal(b_in.detach().numpy(), np.asarray(jb_in))


def test_fused_falls_back_when_unsupported(crossmodal):
    """Soft resampling is outside B3: the per-step path runs (bitwise the
    plain per-step path), packing_report says why, and one warning says it
    too."""
    tm = crossmodal[2]
    defn = dataclasses.replace(tm.definition, num_particles_eval=30,
                               soft_resample_alpha=0.9)
    obs, controls = _sequences(4, 1, seed=5)
    g = torch.Generator().manual_seed(0)
    args = (ParticleBelief(torch.randn(1, 30, 3, generator=g),
                           torch.full((1, 30), -float(np.log(30)))),
            {k: torch.from_numpy(v) for k, v in obs.items()}, torch.from_numpy(controls))
    draws = dict(eps_seq=torch.randn(4, 30, 3, generator=g),
                 uniforms_seq=torch.rand(4, 1, 30, generator=g))
    _, est_a = defn.forward_loop(*args, train=False, **draws)
    with pytest.warns(UserWarning, match="soft resampling"):
        _, est_b = with_fused_step(defn).forward_loop(*args, train=False, **draws)
    assert fused_step.packing_report() == "soft resampling"
    torch.testing.assert_close(est_a, est_b, atol=0, rtol=0)


def test_with_fused_step_sets_the_field_and_shares_the_nets(crossmodal):
    tm = crossmodal[2]
    fused = with_fused_step(tm.definition)
    assert fused.fused_step and not tm.definition.fused_step
    assert fused.dynamics_model is tm.definition.dynamics_model
    assert not with_fused_step(fused, False).fused_step


# ---------------------------------------------------------------------------
# The serving knobs of StatefulFilter
# ---------------------------------------------------------------------------


def test_fused_step_knob_sets_the_field(monkeypatch):
    monkeypatch.setenv("MMF_TPU_FUSED_STEP", "1")
    # Accepted and without effect in the port.
    monkeypatch.setenv("MMF_TPU_PALLAS", "1")
    monkeypatch.setenv("MMF_TPU_SCAN_UNROLL", "4")
    model = tdoor.DoorCrossmodalParticleFilter(device="cpu")
    assert model.definition.fused_step
    monkeypatch.delenv("MMF_TPU_FUSED_STEP")
    assert not tdoor.DoorCrossmodalParticleFilter(device="cpu").definition.fused_step


def _serving_fields(env, monkeypatch):
    """(port, JAX) serving fields of DoorUnimodalParticleFilter built under
    `env` by each facade: each measurement model's compute dtype and fold
    (on the JAX net), the stack flag and fused_step. The JAX init is traced,
    not compiled."""
    from multimodalfilter_tpu.filtering import wrappers as jwrappers

    for k in ("MMF_TPU_SERVING", "MMF_TPU_BF16", "MMF_TPU_FOLD_ENC", "MMF_TPU_STACK_ENC",
              "MMF_TPU_FUSED_STEP"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    port = tdoor.DoorUnimodalParticleFilter(device="cpu").definition
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jwrappers.jax, "jit", lambda fn: lambda *a: jax.eval_shape(fn, *a))
        jax_def = jdoor.DoorUnimodalParticleFilter().definition

    def fields(defn, dtype_of, fold_of):
        mm = defn.measurement_model
        return ([(dtype_of(sub), fold_of(sub)) for sub in mm.measurement_models],
                mm.stack_image_encoders, defn.fused_step)

    return (fields(port, lambda sub: None if sub.dtype is None else str(sub.dtype)[6:],
                   lambda sub: sub.fold_tail),
            fields(jax_def, lambda sub: None if sub.net.dtype is None
                   else str(jnp.dtype(sub.net.dtype)), lambda sub: sub.net.fold_tail))


@pytest.mark.parametrize("env,item", [
    ({"MMF_TPU_SERVING": "1"}, "A8"),
    ({"MMF_TPU_BF16": "1"}, "A8"),
    ({"MMF_TPU_FOLD_ENC": "1"}, "A8"),
    ({"MMF_TPU_STACK_ENC": "1"}, "A12"),
])
def test_unported_knobs_raise(monkeypatch, env, item):
    """The knobs once refused, now honoured (ported by ROADMAP `item`): each
    sets the same fields as the JAX facade under the same environment."""
    del item
    port, want = _serving_fields(env, monkeypatch)
    assert port == want
    assert port != _serving_fields({}, monkeypatch)[0]


def test_serving_knob_with_its_unported_parts_off_builds(monkeypatch):
    """MMF_TPU_SERVING=1 with its bf16 and fold parts turned off builds the
    plain def, as the JAX facade's: no transform, no fused step."""
    env = {"MMF_TPU_SERVING": "1", "MMF_TPU_BF16": "0", "MMF_TPU_FOLD_ENC": "0"}
    port, want = _serving_fields(env, monkeypatch)
    assert port == want == _serving_fields({}, monkeypatch)[0]
    assert not port[2]
