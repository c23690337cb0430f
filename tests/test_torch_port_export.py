"""The port's serving export (``experiments/export.py``) and the custom ops
that carry B1 and B3 into an exported program (``ops/custom_ops.py``), on the CPU, against the port's
own models and the JAX package's bundles.

- The ops: ``torch.library.opcheck`` (schema, fake implementation, no
  mutation) and each op bitwise equal to its plain function.
- A bundle replays the live model bitwise (the port's counterpart of
  ``tests/test_export.py``): the plain PF (its loop program holds one
  ``mmf_torch::pf_tail`` a step), the crossmodal KF, the LSTM, the crossmodal
  PF on the fused route (one ``mmf_torch::fused_forward``, B3's plain
  version here) with its enabled mask frozen, a T=1 bundle streamed step by
  step, a wrong shape refused and a CUDA bundle refused without CUDA. (The
  export CLI, and a bundle run in a process that imports no model code,
  are in ``test_torch_port_surface.py``.)
- Against JAX (its models' init traced, not compiled, and numpy weights,
  swapped into the port's bundles): the deterministic classes' bundles
  agree with the JAX package's bundles within 1e-5 of scale (fp32
  nets summed in other orders); the PF's exported loop program, fed the JAX
  run's belief, noise and uniforms, matches JAX's ``forward_loop`` within
  1e-4 of scale (the eval tests' ``LOOP_ATOL``: fp32 nets carried through
  the steps) up to each trajectory's first resampling tie (a uniform within
  1e-6 of a CDF entry may pick a neighbour on either side).

Shapes: N=2, T=2 (T=1 for the KF, whose traced program grows fastest with
T), M=32 for the PFs; the door nets at units 64.
"""

import copy
import dataclasses
import json
import os
import shutil

import jax
import numpy as np
import pytest
import torch

from crossmodal.tasks import DoorTask as JaxDoorTask
from multimodalfilter_tpu.experiments import export as jexport
from multimodalfilter_tpu.filtering import wrappers as jwrappers
from multimodalfilter_tpu_torch.crossmodal import door_models as tdoor
from multimodalfilter_tpu_torch.experiments.export import (
    export_serving_bundle,
    load_serving_bundle,
)
from multimodalfilter_tpu_torch.filtering import pf as tpf
from multimodalfilter_tpu_torch.ops import custom_ops, fused_step, pf_kernels
from multimodalfilter_tpu_torch.types import ParticleBelief
from multimodalfilter_tpu_torch.weights import params_from_jax

N, T, M = 2, 2, 32
# The deterministic classes' loop lengths: the EKF's traced program grows
# fastest with T (its jacrev), so one step.
T_DET = {"DoorCrossmodalKalmanFilter": 1, "DoorLSTMFilter": 2}
TIE = 1e-6
LOOP_ATOL = 1e-4
DET_RTOL = 1e-5
# opcheck's checks of the schema (with the absence of mutation), the fake
# implementation and the autograd registration; not its AOT-dispatch
# compile, which the exports below exercise.
OPCHECK = ("test_schema", "test_faketensor", "test_autograd_registration")
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


@pytest.fixture(scope="module", autouse=True)
def no_knobs():
    with pytest.MonkeyPatch.context() as mp:
        for name in KNOBS:
            mp.delenv(name, raising=False)
        yield mp


def _sequence(t, seed=42):
    rng = np.random.default_rng(seed)

    def arr(*shape):
        return rng.normal(size=shape).astype(np.float32)

    obs = {"image": arr(t, N, 32, 32), "gripper_pos": arr(t, N, 3),
           "gripper_sensors": arr(t, N, 7)}
    return obs, arr(t, N, 7)


def _moments(d=3):
    mean = np.zeros((N, d), np.float32)
    cov = np.broadcast_to(np.eye(d, dtype=np.float32) * 0.1, (N, d, d)).copy()
    return mean, cov


def _port(name, m=M, **env):
    """A port door model on the CPU, built under `env`, in eval mode, with M
    eval particles where it has particles."""
    with pytest.MonkeyPatch.context() as mp:
        for k, v in env.items():
            mp.setenv(k, v)
        model = getattr(tdoor, name)(device="cpu")
    if hasattr(model.definition, "num_particles_eval"):
        model.definition = dataclasses.replace(model.definition, num_particles_eval=m)
    return model.eval()


def _replay(model, served, t, seeds=(42, 7)):
    """Two consecutive loops of the live model and of the loaded bundle, both
    from seed 0's schedule: (live estimates, bundle estimates) of each."""
    mean, cov = _moments(model.state_dim)
    model.generator.manual_seed(0)
    served.generator.manual_seed(0)
    assert served.state_dim == model.state_dim
    model.initialize_beliefs(mean=mean, covariance=cov)
    served.initialize_beliefs(mean=mean, covariance=cov)
    out = []
    for seed in seeds:
        obs, ctrl = _sequence(t, seed)
        out.append((model.forward_loop(observations=obs, controls=ctrl),
                    served.forward_loop(observations=obs, controls=ctrl)))
    return out


def _op_count(served, name):
    return sum(1 for n in served.loop_program.graph.nodes
               if f"mmf_torch.{name}" in str(n.target))


@pytest.fixture(scope="module")
def bundles(tmp_path_factory):
    """name -> (live port model, bundle path, the bundle loaded), exported
    and loaded once for the module (a test reseeds the loaded bundle's
    generator and initialises its belief, which is what loading anew does)."""
    out = {}
    for name, t in (("DoorParticleFilter", T), *T_DET.items()):
        model = _port(name)
        obs, ctrl = _sequence(t)
        path = export_serving_bundle(model, str(tmp_path_factory.mktemp(name) / "bundle"),
                                     observations=obs, controls=ctrl)
        out[name] = (model, path, load_serving_bundle(path))
    return out


# -- the custom ops -----------------------------------------------------------


def _tail_inputs(seed=0, n=3, m=17, d=3):
    g = torch.Generator().manual_seed(seed)
    lw = torch.log_softmax(torch.randn(n, m, generator=g), dim=1)
    return (lw, torch.randn(n, m, generator=g), torch.randn(n, m, d, generator=g),
            torch.rand(n, m, generator=g))


@pytest.mark.parametrize("alpha", [1.0, 0.5])
def test_pf_tail_op(alpha):
    args = _tail_inputs()
    torch.library.opcheck(torch.ops.mmf_torch.pf_tail.default, (*args, alpha),
                          test_utils=OPCHECK)
    got = torch.ops.mmf_torch.pf_tail(*args, alpha)
    want = pf_kernels.pf_update_and_resample_reference(*args, alpha=alpha)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_fused_forward_op():
    """B3's op on the operands of a crossmodal PF's loop (packed as its
    fused route packs them) against ``fused_step.fused_forward``."""
    model = _port("DoorCrossmodalParticleFilter", m=8)
    defn = model.definition
    obs, ctrl = _sequence(3)
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        features, ctrl_features = defn.encode_sequences(
            model._to_device(obs), model._to_device(ctrl))
        eps = torch.randn(3, N * 8, 3, generator=g)
        ops = fused_step.pack_operands(defn, features, ctrl_features, eps, None, 8)
        belief = ParticleBelief(torch.randn(N, 8, 3, generator=g),
                                torch.log_softmax(torch.randn(N, 8, generator=g), 1))
        uniforms = torch.rand(3, N, 8, generator=g)
        args = (belief.particles, belief.log_weights, uniforms,
                *(getattr(ops, f.name) for f in dataclasses.fields(ops)))
        torch.library.opcheck(torch.ops.mmf_torch.fused_forward.default, args,
                              test_utils=OPCHECK)
        got_belief, got = custom_ops.fused_forward_op(ops, belief, uniforms)
        want_belief, want = fused_step.fused_forward(ops, belief, uniforms)
    assert torch.equal(got, want)
    for g_, w in zip(got_belief, want_belief):
        assert torch.equal(g_, w)


def test_tracing_is_off_in_eager():
    assert not custom_ops.tracing()


# -- bundles against the live model -------------------------------------------


@pytest.mark.parametrize("name", ["DoorParticleFilter", "DoorCrossmodalKalmanFilter",
                                  "DoorLSTMFilter"])
def test_bundle_replays_model(bundles, name):
    model, bundle, served = bundles[name]
    t = T_DET.get(name, T)
    for want, got in _replay(model, served, t):
        assert torch.equal(want, got)
    with open(os.path.join(bundle, "meta.json")) as f:
        meta = json.load(f)
    assert meta["definition"] == type(model.definition).__name__
    assert meta["device"] == "cpu" and meta["fused_route"] is None
    if name == "DoorParticleFilter":  # the per-step path: one tail op a step
        assert _op_count(served, "pf_tail") == T
        assert meta["loop_draws"] == [["normal", [T, N * M, 3]], ["uniform", [T, N, M]]]
    else:
        assert meta["init_draws"] == meta["loop_draws"] == []


def test_fused_route_bundle_replays_model(tmp_path):
    """The crossmodal PF on the fused route, with the image modality
    disabled: the mask freezes into the program (B3 packs one modality) and
    into meta.json."""
    model = _port("DoorCrossmodalParticleFilter", MMF_TPU_FUSED_STEP="1")
    assert model.definition.fused_step
    model.enabled_models = [False, True]
    obs, ctrl = _sequence(2)
    bundle = export_serving_bundle(model, str(tmp_path / "b"), observations=obs,
                                   controls=ctrl)
    with open(os.path.join(bundle, "meta.json")) as f:
        meta = json.load(f)
    assert meta["fused_route"] is True and meta["packing_report"] is None
    assert meta["enabled"] == [False, True]
    served = load_serving_bundle(bundle)
    assert _op_count(served, "fused_forward") == 1 and _op_count(served, "pf_tail") == 0
    for want, got in _replay(model, served, 2):
        assert torch.equal(want, got)


def test_bundle_shape_mismatch_fails(bundles):
    served = bundles["DoorParticleFilter"][2]
    served.initialize_beliefs(mean=_moments()[0], covariance=_moments()[1])
    obs, ctrl = _sequence(T)
    with pytest.raises(ValueError, match="exported shape"):
        served.forward_loop(observations={k: np.concatenate([v, v]) for k, v in obs.items()},
                            controls=np.concatenate([ctrl, ctrl]))
    with pytest.raises(ValueError, match="keys"):
        served.forward_loop(observations={"image": obs["image"]}, controls=ctrl)


def test_bundle_streaming_single_step(tmp_path):
    """A T=1 bundle consumes one step per call, its belief and draws
    persisting: the steps equal the live facade's, streamed the same way."""
    model = _port("DoorParticleFilter")
    obs, ctrl = _sequence(T)
    bundle = export_serving_bundle(model, str(tmp_path / "b"),
                                   observations={k: v[:1] for k, v in obs.items()},
                                   controls=ctrl[:1])
    mean, cov = _moments()
    served = load_serving_bundle(bundle, seed=0)
    model.initialize_beliefs(mean=mean, covariance=cov)
    served.initialize_beliefs(mean=mean, covariance=cov)
    for t in range(T):
        step = ({k: v[t:t + 1] for k, v in obs.items()}, ctrl[t:t + 1])
        want = model.forward_loop(observations=step[0], controls=step[1])
        got = served.forward_loop(observations=step[0], controls=step[1])
        assert torch.equal(want, got) and torch.isfinite(got).all()
    assert torch.equal(model.belief.particles, served.belief.particles)


def test_cuda_bundle_refused_without_cuda(bundles, tmp_path, monkeypatch):
    target = shutil.copytree(bundles["DoorLSTMFilter"][1], tmp_path / "cuda_bundle")
    with open(target / "meta.json") as f:
        meta = json.load(f)
    meta["device"] = "cuda"
    with open(target / "meta.json", "w") as f:
        json.dump(meta, f)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="exported for CUDA"):
        load_serving_bundle(str(target))


# -- against the JAX package ----------------------------------------------------


def _jax_model(name, seed=0):
    """The JAX model with its init traced (eval_shape), not compiled, and
    numpy weights: kernels of variance 1/fan_in, biases 0.1 sigma."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jwrappers.jax, "jit", lambda fn: lambda *a: jax.eval_shape(fn, *a))
        jm = JaxDoorTask.model_types[name]()
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        if path[-1].key == "bias":
            return (0.1 * rng.normal(size=leaf.shape)).astype(np.float32)
        fan_in = int(np.prod(leaf.shape[:-1]))
        return (rng.normal(size=leaf.shape) / np.sqrt(fan_in)).astype(np.float32)

    jm.params = jax.tree_util.tree_map_with_path(draw, jm.params)
    jm.eval()
    return jm


def _with_weights(served, jax_params):
    """A copy of the loaded bundle with the JAX weights in place of its own
    (the programs take the parameters as an input), its generator reseeded."""
    served = copy.copy(served)
    served.params = {**served.params, **params_from_jax(jax_params)}
    served.generator.manual_seed(0)
    return served


def _scale(x):
    return max(1.0, float(np.abs(x).max()))


@pytest.mark.parametrize("name", ["DoorCrossmodalKalmanFilter", "DoorLSTMFilter"])
def test_deterministic_bundle_matches_jax_bundle(bundles, tmp_path, name):
    jm = _jax_model(name)
    obs, ctrl = _sequence(T_DET[name], seed=3)
    jbundle = jexport.export_serving_bundle(
        jm, str(tmp_path / "jax"),
        observations={k: jax.numpy.asarray(v) for k, v in obs.items()},
        controls=jax.numpy.asarray(ctrl))
    mean, cov = _moments()
    jserved = jexport.load_serving_bundle(jbundle)
    tserved = _with_weights(bundles[name][2], jm.params)
    for served in (jserved, tserved):
        served.initialize_beliefs(mean=mean, covariance=cov)
    want = np.asarray(jserved.forward_loop(observations=obs, controls=ctrl))
    got = tserved.forward_loop(observations=obs, controls=ctrl).numpy()
    np.testing.assert_allclose(got, want, atol=DET_RTOL * _scale(want), rtol=0)


def _jax_loop_draws(key, t, n, m, d):
    """JAX forward_loop's pre-draw: T keys, each split, normal (N*M, D) and
    uniform (N, M)."""
    pairs = jax.vmap(jax.random.split)(jax.random.split(key, t))
    eps = jax.vmap(lambda k: jax.random.normal(k, (n * m, d)))(pairs[:, 0])
    uni = jax.vmap(lambda k: jax.random.uniform(k, (n, m)))(pairs[:, 1])
    return torch.from_numpy(np.array(eps)), torch.from_numpy(np.array(uni))


def test_pf_loop_program_matches_jax(bundles, monkeypatch):
    """The PF bundle's loop program, fed JAX's weights (the programs take
    the parameters as an input), belief, noise and uniforms, against JAX's
    forward_loop, and bitwise against the live port loop on those inputs."""
    jm = _jax_model("DoorParticleFilter")
    jdefn = dataclasses.replace(jm.definition, num_particles_eval=M)
    served = _with_weights(bundles["DoorParticleFilter"][2], jm.params)
    model = _port("DoorParticleFilter")
    model.load_jax_params(jm.params)
    obs, ctrl = _sequence(T, seed=3)
    mean, cov = _moments()
    k_init, k_loop = jax.random.split(jax.random.PRNGKey(5))
    jbelief = jdefn.initialize_beliefs(jm.params, k_init, mean, cov, train=False)
    want = np.asarray(jdefn.forward_loop(jm.params, jbelief, obs, ctrl, k_loop, train=False)[1])
    eps, uni = _jax_loop_draws(k_loop, T, N, M, 3)
    belief = ParticleBelief(*(torch.from_numpy(np.array(x)) for x in jbelief))
    obs_t, ctrl_t = model._to_device(obs), model._to_device(ctrl)
    _, got = served.loop_program(served.params, tuple(belief), obs_t, ctrl_t, eps, uni)

    gaps, real_tail = [], tpf.pf_update_and_resample

    def recording_tail(log_weights, log_liks, particles, uniforms, **kwargs):
        _, cdf = pf_kernels.resample_cdf(log_weights, log_liks)
        gaps.append(pf_kernels.tie_gaps(cdf, uniforms).amin(dim=1))
        return real_tail(log_weights, log_liks, particles, uniforms, **kwargs)

    monkeypatch.setattr(tpf, "pf_update_and_resample", recording_tail)
    _, live = model.definition.forward_loop(belief, obs_t, ctrl_t, train=False,
                                            eps_seq=eps, uniforms_seq=uni)
    assert torch.equal(got, live)
    tie = (torch.stack(gaps) <= TIE).numpy()  # (T, N)
    first_tie = np.where(tie.any(axis=0), tie.argmax(axis=0), T)
    compared = np.arange(T)[:, None] <= first_tie[None, :]
    assert compared.sum() >= N * 2
    np.testing.assert_allclose(got.numpy()[compared], want[compared],
                               atol=LOOP_ATOL * _scale(want), rtol=0)
