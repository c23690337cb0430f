"""The port's push model zoo against the JAX package on the CPU, at the
published width (units 64, state 2, control 7): the registry, each of the
ten push classes' filtering (particle filters up to their first resampling
tie, Kalman filters a step at a time from a shared belief under every
enabled pattern of their curriculum, the LSTM over the whole loop), B3's
plain version (the port's fused route) against the JAX fused route on the
push crossmodal PF at D=2, one ``train_e2e`` optimizer step of
``PushCrossmodalParticleFilter`` and one ``train_virtual_sensor`` step of a
push Kalman filter's child; and the curricula of
``train_push.run_curriculum`` against the JAX CLI's.

The JAX models are built with their init traced, not compiled
(``eval_shape``); both sides get the same weights drawn from numpy (kernels
with variance 1/fan_in, biases 0.1 sigma) through ``load_jax_params``, the
same numpy inputs, and the JAX side's noise and uniforms, repeated with
``jax.random`` and handed to the port.
"""

import dataclasses
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from crossmodal import push_models as jpush
from crossmodal.tasks import DoorTask as JaxDoorTask
from crossmodal.tasks import PushTask as JaxPushTask
from multimodalfilter_tpu import train as jtrain
from multimodalfilter_tpu.data import SingleStepDataset as JaxSingleStepDataset
from multimodalfilter_tpu.experiments import Buddy as JaxBuddy
from multimodalfilter_tpu.filtering import ParticleFilterDef as JaxPFDef
from multimodalfilter_tpu.filtering import wrappers as jwrappers
from multimodalfilter_tpu.ops import pallas_fused_step as jfused
from multimodalfilter_tpu.types import GaussianBelief as JaxGaussian
from multimodalfilter_tpu.types import ParticleBelief as JaxBelief
from multimodalfilter_tpu.types import Trajectory as JaxTrajectory
from multimodalfilter_tpu_torch import train as ttrain
from multimodalfilter_tpu_torch.crossmodal import push_models as tpush
from multimodalfilter_tpu_torch.crossmodal.tasks import DoorTask, PushTask
from multimodalfilter_tpu_torch.data import SingleStepDataset, SubsequenceDataset
from multimodalfilter_tpu_torch.experiments import Buddy
from multimodalfilter_tpu_torch.filtering import ParticleFilterDef
from multimodalfilter_tpu_torch.filtering import pf as tpf
from multimodalfilter_tpu_torch.ops import fused_step, pf_kernels
from multimodalfilter_tpu_torch.train import loops as tloops
from multimodalfilter_tpu_torch.train import optim as toptim
from multimodalfilter_tpu_torch.types import GaussianBelief, ParticleBelief, Trajectory
from multimodalfilter_tpu_torch.weights import params_from_jax
from test_torch_port_fused import _flax_trunk
from multimodalfilter_tpu_torch.scripts.push_task import train_push
from test_torch_port_lstm import _numpy_tree
from test_torch_port_train_cli import FakeBuddy, Recorder

REPO = Path(__file__).resolve().parents[1]
D = 2
N, T, M = 2, 3, 16
PUSH_CLASSES = sorted(JaxPushTask.model_types)
KF_PATTERNS = {"PushCrossmodalKalmanFilter": [(True, True), (True, False), (False, True)],
               "PushUnimodalKalmanFilter": [(True, True), (True, False), (False, True)]}
TIE = 1e-6  # fp32 CDFs summed in different orders differ by ~1e-7
# Particle filter estimates after T = 3 steps: fp32 nets (convolutions,
# 64-wide trunks) in two frameworks, reassociated sums carried through the
# recursion, as tests/test_torch_port_pf.py holds the door PFs.
LOOP_ATOL = 1e-4
# A Kalman step from a shared belief, relative to the values' scale: the
# fp32 nets, a 2x2 Cholesky solve a child and, in the unimodal KF, the
# inverses of the children's covariances (tests/test_torch_port_kf_fusion.py).
KF_STEP_RTOL = 1e-4
# One optimizer step: the loss relative (fp32 nets carried through L-1 = 3
# filter steps); each parameter's gradient relative to its largest entry,
# 1e-4: sums of up to ~10^4 fp32 terms in another order in each framework
# (measured at most 9.5e-6 of scale, the gate's sensor encoder, with every
# convolution below 8e-6).
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
ZERO_GRAD_ATOL = 1e-6
# Adam's first step is lr * g / (|g| + 1e-8): where the two gradients have
# the same sign it moves by at most 1e-8 |dg| / g^2 lr, so within 1e-3 lr
# beyond the parameter's fp32 rounding (2 ulp); entries whose gradients are
# within their own difference of zero may step +lr on one side and -lr on
# the other, and are left out.
UPDATE_ATOL_LR = 1e-3
# Virtual-sensor pretraining, as tests/test_torch_port_kf_train.py: each
# parameter's update in relative L2 norm (1e-1, against 1.0 when wrong).
UPDATE_RTOL = 1e-1


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread while this module runs (the suite runs in several
    worker processes at once). Restored after the module."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _traced(build):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jwrappers.jax, "jit", lambda fn: lambda *a: jax.eval_shape(fn, *a))
        return build()


@pytest.fixture(scope="module")
def zoo():
    """name -> (JAX facade, numpy param tree, port facade), the same
    weights; the facades in eval mode."""
    out = {}
    for i, name in enumerate(PUSH_CLASSES):
        jm = _traced(JaxPushTask.model_types[name])
        tree = _numpy_tree(jm.params, seed=40 + i)
        jm.params = jax.tree_util.tree_map(jnp.asarray, tree)
        jm.frozen_paths.clear()
        tm = PushTask.model_types[name](device="cpu")
        tm.load_jax_params(tree)
        jm.eval()
        tm.eval()
        out[name] = (jm, tree, tm)
    return out


def _sequences(t, n, seed):
    r = np.random.default_rng(seed)
    obs = {"image": r.normal(size=(t, n, 32, 32)).astype(np.float32),
           "gripper_pos": r.normal(size=(t, n, 3)).astype(np.float32),
           "gripper_sensors": r.normal(size=(t, n, 7)).astype(np.float32)}
    return obs, (0.3 * r.normal(size=(t, n, 7))).astype(np.float32)


def _torch(tree):
    if isinstance(tree, dict):
        return {k: _torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.asarray(tree))


def _close(got, want, rtol):
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got.detach()), want, atol=rtol * scale, rtol=0)


def test_registry_holds_the_ten_push_classes():
    """PushTask registers exactly the ten push classes, none of the door's;
    DoorTask's registry is the JAX package's; the package exports the JAX
    package's 15 push names."""
    assert sorted(PushTask.model_types) == PUSH_CLASSES
    assert len(PUSH_CLASSES) == 10 and all(n.startswith("Push") for n in PUSH_CLASSES)
    assert sorted(DoorTask.model_types) == sorted(JaxDoorTask.model_types)
    assert not set(PushTask.model_types) & set(DoorTask.model_types)
    jax_names = sorted(n for n in dir(jpush) if n.startswith("Push"))
    assert len(jax_names) == 15
    assert sorted(n for n in tpush.__all__ if n.startswith("Push")) == jax_names
    for name in PUSH_CLASSES:
        assert PushTask.model_types[name] is getattr(tpush, name)


def _jax_draws(key, t, n, m):
    """JAX forward_loop's pre-draw: split into T keys, split each, normal
    (N*M, D) and uniform (N, M)."""
    pairs = jax.vmap(jax.random.split)(jax.random.split(key, t))
    eps = jax.vmap(lambda k: jax.random.normal(k, (n * m, D)))(pairs[:, 0])
    uni = jax.vmap(lambda k: jax.random.uniform(k, (n, m)))(pairs[:, 1])
    return torch.from_numpy(np.array(eps)), torch.from_numpy(np.array(uni))


def _pf_matches(jm, tm, obs, controls, monkeypatch):
    r = np.random.default_rng(3)
    particles = (0.3 * r.normal(size=(N, M, D))).astype(np.float32)
    lw = np.full((N, M), -np.log(M), np.float32)
    defn = dataclasses.replace(jm.definition, pallas_resample=True, num_particles_eval=M)
    key = jax.random.PRNGKey(42)
    (jp, _), est_j = jax.jit(lambda p, b, o, c, k: defn.forward_loop(p, b, o, c, k, train=False))(
        jm.params, JaxBelief(jnp.asarray(particles), jnp.asarray(lw)),
        jax.tree_util.tree_map(jnp.asarray, obs), jnp.asarray(controls), key)
    eps, uni = _jax_draws(key, T, N, M)
    gaps = []
    real = tpf.pf_update_and_resample

    def recording(log_weights, log_liks, parts, uniforms, **kwargs):
        gaps.append(float(pf_kernels.draw_gaps(log_weights, log_liks, uniforms).min()))
        return real(log_weights, log_liks, parts, uniforms, **kwargs)

    monkeypatch.setattr(tpf, "pf_update_and_resample", recording)
    (tp, _), est_t = dataclasses.replace(tm.definition, num_particles_eval=M).forward_loop(
        ParticleBelief(torch.from_numpy(particles), torch.from_numpy(lw)), _torch(obs),
        torch.from_numpy(controls), train=False, eps_seq=eps, uniforms_seq=uni)
    assert len(gaps) == T and est_t.shape == (T, N, D) and torch.isfinite(est_t).all()
    # A step's estimate precedes its resampling: the estimates agree through
    # the first step whose draw lies on a tie, the particles where none does.
    first_tie = next((t for t, g in enumerate(gaps) if g <= TIE), T)
    last = min(first_tie, T - 1)
    _close(est_t[: last + 1], np.asarray(est_j)[: last + 1], LOOP_ATOL)
    if first_tie == T:
        _close(tp, jp, LOOP_ATOL)


def _kf_belief(name, seed=5):
    r = np.random.default_rng(seed)
    a = (0.2 * r.normal(size=(N, D, D))).astype(np.float32)
    cov = (a @ a.transpose(0, 2, 1) + 0.05 * np.eye(D, dtype=np.float32)).astype(np.float32)
    mean = (0.3 * r.normal(size=(N, D))).astype(np.float32)
    one = (mean, cov)
    return (one, one) if name == "PushUnimodalKalmanFilter" else one


def _flat(belief):
    if isinstance(belief, tuple) and not hasattr(belief, "mean"):
        return [x for b in belief for x in b]
    return list(belief)


def _kf_matches(name, jm, tm, obs, controls):
    """Every step from the JAX run's belief at that step, under every
    enabled pattern of the class's curriculum."""
    start = _kf_belief(name)
    if name == "PushUnimodalKalmanFilter":
        jb0 = tuple(JaxGaussian(jnp.asarray(m), jnp.asarray(c)) for m, c in start)
    else:
        jb0 = JaxGaussian(jnp.asarray(start[0]), jnp.asarray(start[1]))
    for enabled in KF_PATTERNS.get(name, [None]):
        step = jax.jit(lambda p, b, o, c, enabled=enabled: jm.definition.step(
            p, b, o, c, None, train=False, enabled=enabled))
        jb = jb0
        for t in range(T):
            frame = {k: v[t] for k, v in obs.items()}
            jnew, jest = step(jm.params, jb, frame, controls[t])
            tb = jax.tree_util.tree_map(lambda x: torch.from_numpy(np.asarray(x)), jb)
            if name == "PushUnimodalKalmanFilter":
                tb = tuple(GaussianBelief(*b) for b in tb)
            else:
                tb = GaussianBelief(*tb)
            tnew, test_ = tm.definition.step(tb, _torch(frame), torch.from_numpy(controls[t]),
                                             train=False, enabled=enabled)
            assert np.isfinite(np.asarray(jest)).all()
            _close(test_, jest, KF_STEP_RTOL)
            for g, w in zip(_flat(tnew), _flat(jnew)):
                _close(g, w, KF_STEP_RTOL)
            jb = jnew


@pytest.mark.parametrize("name", PUSH_CLASSES)
def test_push_class_filtering_matches_jax(zoo, name, monkeypatch):
    """Each push class against its JAX class from the same numpy weights:
    PFs (M = 16) through their first resampling tie, KFs a step at a time
    from a shared belief, the LSTM over the whole loop (N = 2, T = 3)."""
    jm, _, tm = zoo[name]
    obs, controls = _sequences(T, N, seed=7)
    if isinstance(tm.definition, ParticleFilterDef):
        assert tm.definition.state_dim == D
        _pf_matches(jm, tm, obs, controls, monkeypatch)
    elif name == "PushLSTMFilter":
        mean = np.zeros((N, D), np.float32)
        cov = np.tile(np.eye(D, dtype=np.float32) * 0.1, (N, 1, 1))
        jm.initialize_beliefs(mean=jnp.asarray(mean), covariance=jnp.asarray(cov))
        want = np.asarray(jm.forward_loop(
            observations=jax.tree_util.tree_map(jnp.asarray, obs),
            controls=jnp.asarray(controls)))
        tm.initialize_beliefs(mean=mean, covariance=cov)
        got = tm.forward_loop(observations=obs, controls=controls)
        assert got.shape == (T, N, D)
        _close(got, want, LOOP_ATOL)
    else:
        _kf_matches(name, jm, tm, obs, controls)


def test_push_fused_route_matches_jax_fused_kernel(monkeypatch):
    """B3's plain version, the port's fused route on the CPU, against the JAX
    fused route (Pallas, interpret mode) on the push crossmodal PF at D = 2,
    K = 2, from the port model's trunks (N = 2, T = 3, M = 16): the
    estimates through each trajectory's first draw on a tie."""
    from multimodalfilter_tpu_torch.filtering.wrappers import with_fused_step

    tm = tpush.PushCrossmodalParticleFilter(device="cpu", seed=7)
    mm = tm.definition.measurement_model
    jmm = jpush.models.CrossmodalPFMeasurementDef(
        measurement_models=(jpush.PushMeasurementModel(modalities={"image"}),
                            jpush.PushMeasurementModel(modalities={"pos", "sensors"})),
        crossmodal_weight_model=jpush.PushCrossmodalWeightModel(), state_dim=D)
    jdefn = JaxPFDef(dynamics_model=jpush.PushDynamicsModel(), measurement_model=jmm,
                     state_dim=D, num_particles_eval=M, pallas_resample=True,
                     fused_step=True)
    params = {"dynamics_model": _flax_trunk(tm.definition.dynamics_model.net),
              "measurement_model": {"measurement_models": {
                  str(i): _flax_trunk(sub.net) for i, sub in enumerate(mm.measurement_models)}}}
    obs, controls = _sequences(T, N, seed=11)
    r = np.random.default_rng(12)
    particles = (0.3 * r.normal(size=(N, M, D))).astype(np.float32)
    lw = np.full((N, M), -np.log(M), np.float32)
    eps = r.normal(size=(T, N * M, D)).astype(np.float32)
    uni = r.uniform(size=(T, N, M)).astype(np.float32)
    tdefn = with_fused_step(dataclasses.replace(tm.definition, num_particles_eval=M))
    with torch.no_grad():
        features, ctrl = tdefn.encode_sequences(_torch(obs), torch.from_numpy(controls))

    def jnp_tree(x):
        return ({k: jnp.asarray(v.numpy()) for k, v in x.items()} if isinstance(x, dict)
                else jnp.asarray(x.numpy()))

    _, est_j = jax.jit(lambda p, b, f, c, e, u: jfused.try_fused_forward(
        jdefn, p, b, f, c, e, u, None, interpret=True))(
        params, JaxBelief(jnp.asarray(particles), jnp.asarray(lw)), jnp_tree(features),
        jnp_tree(ctrl), jnp.asarray(eps), jnp.asarray(uni))
    assert jfused.packing_report() is None, jfused.packing_report()
    gaps = []
    real = fused_step.pf_update_and_resample_reference

    def recording(log_weights, log_liks, parts, uniforms):
        gaps.append(pf_kernels.draw_gaps(log_weights, log_liks, uniforms).amin(dim=1))
        return real(log_weights, log_liks, parts, uniforms)

    monkeypatch.setattr(fused_step, "pf_update_and_resample_reference", recording)
    _, est_t = tdefn.forward_loop(
        ParticleBelief(torch.from_numpy(particles), torch.from_numpy(lw)), _torch(obs),
        torch.from_numpy(controls), train=False, eps_seq=torch.from_numpy(eps),
        uniforms_seq=torch.from_numpy(uni))
    assert fused_step.packing_report() is None, fused_step.packing_report()
    assert len(gaps) == T and est_t.shape == (T, N, D)
    tie = torch.stack(gaps) <= TIE  # (T, N)
    first = torch.where(tie.any(0), tie.float().argmax(0), torch.full((N,), T - 1))
    for i in range(N):
        _close(est_t[: first[i] + 1, i], np.asarray(est_j)[: first[i] + 1, i], LOOP_ATOL)


def _jax_train_push():
    sys.path.insert(0, str(REPO / "scripts" / "push_task"))
    import train_push as jax_train_push

    return jax_train_push


class WarmBuddy(FakeBuddy):
    """A fake buddy whose other experiments exist: a module load from one
    is recorded like any other."""

    def load_checkpoint_module(self, source, target=None, label=None, experiment_name=None):
        self.log.append(("load module", source, target, label, experiment_name))


def _curriculum_log(run_curriculum, model, buddy_cls):
    log = []
    run_curriculum(model, buddy_cls(log), Recorder(log, "train", model),
                   Recorder(log, "eval", model))
    return log


@pytest.mark.parametrize("name,buddy_cls", [
    *(pytest.param(name, FakeBuddy, id=name) for name in PUSH_CLASSES),
    pytest.param("PushCrossmodalParticleFilterSeq5", WarmBuddy,
                 id="PushCrossmodalParticleFilterSeq5-warm-start")])
def test_push_curriculum_matches_jax(name, buddy_cls, zoo):
    """train_push.run_curriculum against the JAX CLI's, with every training
    primitive recorded instead of run and a fake buddy, as
    tests/test_torch_port_train_cli.py holds the door curricula: every
    train_* call with its arguments, each log_eval, each checkpoint
    label, each module load (source, target, label, experiment) and the
    enabled models and frozen paths at each call. Only the Seq5 branch loads
    from another experiment: in a fresh workspace (FileNotFoundError, as the
    port's Buddy raises for a missing experiment) it pretrains from scratch,
    with the warm start it loads the dynamics and measurement models."""
    jm = zoo[name][0]
    jm.frozen_paths.clear()  # an earlier case of the same class froze parts of it
    if jm.enabled_models is not None:
        jm.enabled_models = [True] * len(jm.enabled_models)
    want = _curriculum_log(_jax_train_push().run_curriculum, jm, buddy_cls)
    got = _curriculum_log(train_push.run_curriculum,
                          PushTask.model_types[name](device="cpu"), buddy_cls)
    assert got == want
    assert any(entry[0] == "train" for entry in got)
    if name == "PushCrossmodalParticleFilterSeq5":
        loads = [e for e in got if e[0] == "load module"]
        assert len(loads) == (2 if buddy_cls is WarmBuddy else 0)
        pretrains = [e for e in got if e[0] == "train" and e[1] != "train_e2e"]
        assert len(pretrains) == (0 if buddy_cls is WarmBuddy else 6)


def _trajectories(cls, count=2, t=16, seed=0):
    r = np.random.default_rng(seed)
    out = []
    for _ in range(count):
        obs = {"image": r.normal(size=(t, 32, 32)).astype(np.float32),
               "gripper_pos": r.normal(size=(t, 3)).astype(np.float32),
               "gripper_sensors": r.normal(size=(t, 7)).astype(np.float32)}
        out.append(cls((0.3 * r.normal(size=(t, D))).astype(np.float32), obs,
                       r.normal(size=(t, 7)).astype(np.float32)))
    return out


def _jax_e2e_loss(defn):
    """The loss of the JAX package's train_e2e (train/loops.py:387-413)."""

    def loss_fn(params, batch, key):
        states = jnp.swapaxes(batch["states"], 0, 1)
        controls = jnp.swapaxes(batch["controls"], 0, 1)
        obs = jax.tree_util.tree_map(lambda a: jnp.swapaxes(a, 0, 1), batch["obs"])
        k_init, k_loop = jax.random.split(key)
        cov = jnp.broadcast_to(jnp.eye(D) * 0.1, (states.shape[1], D, D))
        belief = defn.initialize_beliefs(params, k_init, states[0], cov, train=True)
        _, est = defn.forward_loop(params, belief,
                                   jax.tree_util.tree_map(lambda a: a[1:], obs),
                                   controls[1:], k_loop, train=True)
        return jnp.mean((est - states[1:]) ** 2)

    return loss_fn


def test_push_train_e2e_step_matches_jax(zoo):
    """One train_e2e optimizer step of PushCrossmodalParticleFilter (B = 4,
    L = 4, M = 30, the JAX side through B2's custom VJP in interpret mode):
    the loss, every gradient, and one Adam update from the same weights."""
    b, length, m = 4, 4, 30
    jm, tree, _ = zoo["PushCrossmodalParticleFilter"]
    ds = SubsequenceDataset(_trajectories(Trajectory), length)
    batch = {"states": ds.states[:b], "controls": ds.controls[:b],
             "obs": {k: v[:b] for k, v in ds.observations.items()}}
    key = jax.random.PRNGKey(7)
    defn = dataclasses.replace(jm.definition, pallas_resample=True)
    assert defn.num_particles_train == m
    jloss, jgrads = jax.jit(jax.value_and_grad(_jax_e2e_loss(defn)))(
        jm.params, jax.tree_util.tree_map(jnp.asarray, batch), key)
    tx = optax.adam(toptim.DEFAULT_LEARNING_RATE)
    updates, _ = tx.update(jgrads, tx.init(jm.params), jm.params)
    jnew = params_from_jax(jax.tree_util.tree_map(np.asarray, optax.apply_updates(
        jm.params, updates)))
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, jgrads))

    # The JAX loss's draws: the initial particles, then forward_loop's eps.
    k_init, k_loop = jax.random.split(key)
    pairs = jax.vmap(jax.random.split)(jax.random.split(k_loop, length - 1))
    noise = (np.array(jax.random.normal(k_init, (b, m, D))),
             np.array(jax.vmap(lambda k: jax.random.normal(k, (b * m, D)))(pairs[:, 0])))
    tm = tpush.PushCrossmodalParticleFilter(device="cpu")
    tm.load_jax_params(tree)
    start = {k: v.detach().clone() for k, v in tm.params.state_dict().items()}
    real = tloops.draw_noise
    tloops.draw_noise = lambda generator, shapes, device: tuple(map(torch.from_numpy, noise))
    try:
        optimizer = toptim.make_optimizer(tm.params.parameters())
        with torch.enable_grad():  # other test files may switch it off (C1)
            loss = tloops.e2e_loss(tm.definition, tloops._to_device(batch, torch.device("cpu")),
                                   enabled=None, initial_cov_scale=0.1, generator=None)
            loss.backward()
        got = {k: p.grad.clone() for k, p in tm.params.named_parameters()}
        toptim.apply_gradients(optimizer, tm.params, frozenset())
    finally:
        tloops.draw_noise = real
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=LOSS_RTOL)
    assert got.keys() == want.keys()
    lr, resolved = toptim.DEFAULT_LEARNING_RATE, 0
    after = tm.params.state_dict()
    for k, g in got.items():
        scale = float(want[k].abs().max())
        if scale <= ZERO_GRAD_ATOL:
            assert float(g.abs().max()) <= ZERO_GRAD_ATOL, k
            continue
        torch.testing.assert_close(g, want[k], atol=GRAD_RTOL * scale, rtol=0,
                                   msg=lambda msg, k=k: f"{k}: {msg}")
        ok = (want[k].abs() >= 1e-5) & ((g - want[k]).abs() < want[k].abs())
        ulp = 2 * torch.finfo(torch.float32).eps * start[k].abs()
        gap = ((after[k] - start[k]) - (jnew[k] - start[k])).abs() - ulp
        assert not ok.any() or float(gap[ok].max()) <= UPDATE_ATOL_LR * lr, k
        resolved += int(ok.sum())
    assert resolved > 0.5 * sum(g.numel() for g in got.values())


def test_push_train_virtual_sensor_step_matches_jax(zoo, tmp_path):
    """One train_virtual_sensor optimizer step of the push crossmodal KF's
    image child (the spanning-pool virtual sensor): the loss and each
    parameter's update; nothing outside the child's sensor and its z head
    moves."""
    jm, tree, _ = zoo["PushCrossmodalKalmanFilter"]
    jm.params = jax.tree_util.tree_map(jnp.asarray, tree)
    tm = tpush.PushCrossmodalKalmanFilter(device="cpu")
    tm.load_jax_params(tree)
    start = {k: v.detach().clone() for k, v in tm.params.state_dict().items()}
    jbuddy = JaxBuddy("vs", jm, checkpoint_dir=str(tmp_path), metadata_dir=str(tmp_path),
                      log_dir=str(tmp_path / "jax"), verbose=False)
    tbuddy = Buddy("vs", tm, log_dir=str(tmp_path / "torch"))
    trajs = dict(count=1, t=8)
    jloss = jtrain.train_virtual_sensor(
        jbuddy, jm.filter_models[0], JaxSingleStepDataset(_trajectories(JaxTrajectory, **trajs)),
        epochs=1, batch_size=7)
    tloss = ttrain.train_virtual_sensor(
        tbuddy, tm.filter_models[0], SingleStepDataset(_trajectories(Trajectory, **trajs)),
        epochs=1, batch_size=7)
    assert tbuddy.optimizer_steps == jbuddy.optimizer_steps == 1
    np.testing.assert_allclose(tloss, jloss, rtol=LOSS_RTOL)
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, jm.params))
    now = {k: v.detach() for k, v in tm.params.state_dict().items()}
    sensor = "filter_models.0.virtual_sensor_model."
    moved = 0
    for k in want:
        dj, dt = want[k] - start[k], now[k] - start[k]
        if not k.startswith(sensor) or not dj.any():  # the loss reaches z's head only
            assert not dt.any() and not dj.any(), k
            continue
        moved += 1
        assert float((dt - dj).norm() / dj.norm()) <= UPDATE_RTOL, k
    assert moved
