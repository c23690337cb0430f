"""The port's particle filter against the JAX package on the CPU: the B1
plain version against ``pf_update_and_resample`` (Pallas, interpret mode),
the resampling primitives, one PF step, and the eval ``forward_loop`` of the
door PF models at full width (units=64).

Both sides get the same numpy inputs, the same weights (copied through
``multimodalfilter_tpu_torch.weights``) and the same noise and uniforms: the
JAX side draws them from its key inside ``forward_loop``, and the tests
repeat that draw with ``jax.random`` and hand the arrays to the port.

Resampled indices may differ only where a uniform lies within TIE of a CDF
entry (the two sides sum the CDF in different orders); each loop test
asserts that its seed has no such draw, so no tie can make it pass or fail.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crossmodal import door_models as jdoor
from multimodalfilter_tpu.ops.pallas_pf import pf_update_and_resample as jax_b1
from multimodalfilter_tpu.ops.resampling import (
    multinomial_resample as jax_multinomial,
    soft_resample as jax_soft,
)
from multimodalfilter_tpu.types import ParticleBelief as JaxBelief
from multimodalfilter_tpu_torch.crossmodal import door_models as tdoor
from multimodalfilter_tpu_torch.filtering import pf as tpf
from multimodalfilter_tpu_torch.ops import pf_kernels
from multimodalfilter_tpu_torch.ops.resampling import multinomial_resample, soft_resample
from multimodalfilter_tpu_torch.types import ParticleBelief

TIE = 1e-6  # fp32 CDFs summed in different orders differ by ~1e-7
# Estimates after T steps: fp32 nets (conv, 64-wide trunks) in two
# frameworks, reassociated sums compounding over the recursion.
LOOP_ATOL = 1e-4


def _b1_inputs(n, m, d, seed=0):
    r = np.random.default_rng(seed)
    logits = r.normal(size=(n, m)).astype(np.float32)
    lw = (logits - np.log(np.exp(logits).sum(1, keepdims=True))).astype(np.float32)
    ll = r.normal(size=(n, m)).astype(np.float32)
    particles = r.normal(size=(n, m, d)).astype(np.float32)
    uniforms = r.uniform(size=(n, m)).astype(np.float32)
    return lw, ll, particles, uniforms


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _non_tie(cdf, uniforms):
    return pf_kernels.tie_gaps(cdf, uniforms).numpy() > TIE


@pytest.mark.parametrize("n,m,d", [(3, 100, 3), (2, 1, 3), (2, 1024, 2)])
def test_b1_reference_matches_pallas_kernel(n, m, d):
    lw, ll, particles, uniforms = _b1_inputs(n, m, d)
    jp, jlw, jest = jax_b1(lw, ll, particles, uniforms, interpret=True)
    tp, tlw, test = pf_kernels.pf_update_and_resample_reference(
        *_t(lw, ll, particles, uniforms)
    )
    _, cdf = pf_kernels.resample_cdf(*_t(lw, ll))
    ok = _non_tie(cdf, torch.from_numpy(uniforms))
    # Particles are distinct draws, so equal particles <=> equal indices.
    np.testing.assert_array_equal(np.asarray(jp)[ok], tp.numpy()[ok])
    assert ok.mean() > 0.99
    np.testing.assert_allclose(np.asarray(jest), test.numpy(), atol=1e-6, rtol=0)
    np.testing.assert_allclose(np.asarray(jlw), tlw.numpy(), atol=1e-6, rtol=0)


def test_b1_wrapper_takes_the_plain_version_on_cpu():
    args = _t(*_b1_inputs(2, 50, 3))
    before = pf_kernels.launch_b1.launches
    out = pf_kernels.pf_update_and_resample(*args)
    ref = pf_kernels.pf_update_and_resample_reference(*args)
    for a, b in zip(out, ref):
        torch.testing.assert_close(a, b, atol=0, rtol=0)
    assert pf_kernels.launch_b1.launches == before


def test_tie_gaps():
    cdf = torch.tensor([[0.25, 0.5, 1.0]])
    u = torch.tensor([[0.2, 0.5, 0.9999]])
    torch.testing.assert_close(
        pf_kernels.tie_gaps(cdf, u), torch.tensor([[0.05, 0.0, 0.0001]]),
        atol=1e-6, rtol=0,
    )


def test_multinomial_and_soft_resample_match_jax():
    lw, _, particles, uniforms = _b1_inputs(3, 64, 3, seed=1)
    key = jax.random.PRNGKey(0)
    cdf = torch.cumsum(torch.exp(torch.from_numpy(lw)), 1)
    ok = _non_tie(cdf / cdf[:, -1:], torch.from_numpy(uniforms))

    jp, jlw = jax_multinomial(key, particles, lw, uniforms=uniforms)
    tp, tlw = multinomial_resample(*_t(particles, lw), uniforms=torch.from_numpy(uniforms))
    np.testing.assert_array_equal(np.asarray(jp)[ok], tp.numpy()[ok])
    np.testing.assert_allclose(np.asarray(jlw), tlw.numpy(), atol=1e-6, rtol=0)

    alpha = 0.5
    jp, jlw = jax_soft(key, particles, lw, alpha, uniforms=uniforms)
    tp, tlw = soft_resample(*_t(particles, lw), alpha, uniforms=torch.from_numpy(uniforms))
    mix = alpha * np.exp(lw) + (1 - alpha) / lw.shape[1]
    mcdf = torch.cumsum(torch.from_numpy(mix), 1)
    ok = _non_tie(mcdf / mcdf[:, -1:], torch.from_numpy(uniforms))
    assert ok.all()
    np.testing.assert_array_equal(np.asarray(jp), tp.numpy())
    np.testing.assert_allclose(np.asarray(jlw), tlw.numpy(), atol=1e-5, rtol=0)


def test_weighted_average_matches_jax():
    from multimodalfilter_tpu.filtering.fusion import weighted_average as jax_wa
    from multimodalfilter_tpu_torch.filtering import weighted_average

    r = np.random.default_rng(2)
    preds = r.normal(size=(2, 5, 3)).astype(np.float32)
    weights = r.uniform(size=(2, 5, 3)).astype(np.float32)
    np.testing.assert_allclose(
        np.asarray(jax_wa(preds, weights)),
        weighted_average(*_t(preds, weights)).numpy(), atol=1e-6, rtol=0,
    )


# ---------------------------------------------------------------------------
# Whole door PF models at full width
# ---------------------------------------------------------------------------


def _sequences(t, n, seed=0, blackout_frames=()):
    r = np.random.default_rng(seed)
    obs = {
        "image": r.normal(size=(t, n, 32, 32)).astype(np.float32),
        "gripper_pos": r.normal(size=(t, n, 3)).astype(np.float32),
        "gripper_sensors": r.normal(size=(t, n, 7)).astype(np.float32),
    }
    for ti, ni in blackout_frames:
        obs["image"][ti, ni] = 0.0
    controls = r.normal(size=(t, n, 7)).astype(np.float32)
    return obs, controls


def _belief(n, m, seed=1):
    r = np.random.default_rng(seed)
    particles = r.normal(size=(n, m, 3)).astype(np.float32)
    return particles, np.full((n, m), -np.log(m), np.float32)


def _jax_draws(key, t, n, m, d, train):
    """JAX forward_loop's pre-draw (pf.py, hoist_rng): split into T keys,
    split each, normal (N*M, D) and uniform (N, M)."""
    pairs = jax.vmap(jax.random.split)(jax.random.split(key, t))
    eps = jax.vmap(lambda k: jax.random.normal(k, (n * m, d)))(pairs[:, 0])
    uni = None if train else jax.vmap(
        lambda k: jax.random.uniform(k, (n, m))
    )(pairs[:, 1])
    return eps, uni


def _models(jax_cls, torch_cls):
    jm = jax_cls()
    tm = torch_cls(device="cpu")
    tm.load_jax_params(jm.params)
    return jm, tm


def _run_both(jm, tm, t=5, n=2, m=32, enabled=None, train=False,
              blackout_frames=(), monkeypatch=None):
    """Returns (jax estimates, port estimates, per-step tie gaps)."""
    obs, controls = _sequences(t, n, blackout_frames=blackout_frames)
    particles, lw = _belief(n, m)
    field = "num_particles_train" if train else "num_particles_eval"
    defn = dataclasses.replace(jm.definition, pallas_resample=True, **{field: m})
    key = jax.random.PRNGKey(42)
    _, est_j = jax.jit(
        lambda p, b, o, c, k: defn.forward_loop(
            p, b, o, c, k, train=train, enabled=enabled
        )
    )(jm.params, JaxBelief(jnp.asarray(particles), jnp.asarray(lw)),
      jax.tree_util.tree_map(jnp.asarray, obs), jnp.asarray(controls), key)
    eps, uni = _jax_draws(key, t, n, m, 3, train)

    gaps = []
    if monkeypatch is not None:
        # Record each step's CDF against its uniforms (the tie premise).
        real = tpf.pf_update_and_resample

        def recording(log_weights, log_liks, particles, uniforms, **kwargs):
            _, cdf = pf_kernels.resample_cdf(log_weights, log_liks)
            gaps.append(float(pf_kernels.tie_gaps(cdf, uniforms).min()))
            return real(log_weights, log_liks, particles, uniforms, **kwargs)

        monkeypatch.setattr(tpf, "pf_update_and_resample", recording)
    _, est_t = tm.definition.forward_loop(
        ParticleBelief(*_t(particles, lw)),
        {k: torch.from_numpy(v) for k, v in obs.items()},
        torch.from_numpy(controls), train=train, enabled=enabled,
        eps_seq=torch.from_numpy(np.array(eps)),
        uniforms_seq=None if uni is None else torch.from_numpy(np.array(uni)),
    )
    return np.asarray(est_j), est_t.detach().numpy(), gaps


@pytest.fixture(scope="module")
def crossmodal_models():
    return _models(jdoor.DoorCrossmodalParticleFilter, tdoor.DoorCrossmodalParticleFilter)


@pytest.mark.parametrize("enabled", [None, (True, False), (False, True)])
def test_crossmodal_pf_forward_loop_matches_jax(crossmodal_models, enabled, monkeypatch):
    """The slice as a whole: eval forward_loop, M=32, N=2, T=5."""
    jm, tm = crossmodal_models
    est_j, est_t, gaps = _run_both(jm, tm, enabled=enabled, monkeypatch=monkeypatch)
    assert len(gaps) == 5 and min(gaps) > TIE, gaps
    assert np.isfinite(est_t).all() and est_t.shape == (5, 2, 3)
    np.testing.assert_allclose(est_j, est_t, atol=LOOP_ATOL, rtol=0)


def test_crossmodal_pf_train_loop_matches_jax(crossmodal_models):
    """Train mode: the plain tail, no resampling (JAX runs B2 here)."""
    jm, tm = crossmodal_models
    est_j, est_t, _ = _run_both(jm, tm, t=4, m=8, train=True)
    np.testing.assert_allclose(est_j, est_t, atol=LOOP_ATOL, rtol=0)


def test_crossmodal_pf_step_matches_jax(crossmodal_models):
    jm, tm = crossmodal_models
    n, m = 2, 32
    obs, controls = _sequences(1, n, seed=3)
    obs = {k: v[0] for k, v in obs.items()}
    particles, lw = _belief(n, m, seed=4)
    defn = dataclasses.replace(jm.definition, pallas_resample=True,
                               num_particles_eval=m)
    key = jax.random.PRNGKey(5)
    (jp, jlw), jest = defn.step(
        jm.params, JaxBelief(jnp.asarray(particles), jnp.asarray(lw)),
        obs, jnp.asarray(controls[0]), key, train=False,
    )
    k_noise, k_resample = jax.random.split(key)
    eps = jax.random.normal(k_noise, (n * m, 3))
    uni = jax.random.uniform(k_resample, (n, m))
    (tp, tlw), test = tm.definition.step(
        ParticleBelief(*_t(particles, lw)),
        {k: torch.from_numpy(v) for k, v in obs.items()},
        torch.from_numpy(controls[0]), train=False,
        eps=torch.from_numpy(np.array(eps)), uniforms=torch.from_numpy(np.array(uni)),
    )
    np.testing.assert_allclose(np.asarray(jest), test.numpy(), atol=1e-5, rtol=0)
    np.testing.assert_allclose(np.asarray(jp), tp.numpy(), atol=1e-5, rtol=0)
    np.testing.assert_allclose(np.asarray(jlw), tlw.numpy(), atol=1e-6, rtol=0)


def test_seq5_blackout_matches_jax(monkeypatch):
    jm, tm = _models(jdoor.DoorCrossmodalParticleFilterSeq5,
                     tdoor.DoorCrossmodalParticleFilterSeq5)
    est_j, est_t, gaps = _run_both(
        jm, tm, t=3, blackout_frames=((1, 0), (2, 1)), monkeypatch=monkeypatch
    )
    assert min(gaps) > TIE, gaps
    np.testing.assert_allclose(est_j, est_t, atol=LOOP_ATOL, rtol=0)

    # The gate's image log-weight carries the -1e9 blackout on those frames.
    obs, _ = _sequences(3, 2, blackout_frames=((1, 0), (2, 1)))
    gate = tm.definition.measurement_model.crossmodal_weight_model
    with torch.no_grad():
        lw = gate.log_weights({k: torch.from_numpy(v[1]) for k, v in obs.items()})
    assert lw[0, 0] < -1e8 and lw[1, 0] > -1e8


@pytest.mark.parametrize("cls", ["DoorParticleFilter", "DoorUnimodalParticleFilter"])
def test_other_door_pfs_match_jax(cls, monkeypatch):
    jm, tm = _models(getattr(jdoor, cls), getattr(tdoor, cls))
    est_j, est_t, gaps = _run_both(jm, tm, t=3, monkeypatch=monkeypatch)
    assert min(gaps) > TIE, gaps
    np.testing.assert_allclose(est_j, est_t, atol=LOOP_ATOL, rtol=0)


def _facade_run(obs, controls, mean, cov, seed=3):
    model = tdoor.DoorCrossmodalParticleFilter(device="cpu", seed=seed)
    model.eval()
    model.initialize_beliefs(mean=mean, covariance=cov)
    return model, model.forward_loop(observations=obs, controls=controls)


def test_facade_eval_loop_is_seeded_and_gradient_free():
    obs, controls = _sequences(2, 2)
    mean = np.zeros((2, 3), np.float32)
    cov = np.tile(np.eye(3, dtype=np.float32), (2, 1, 1))
    grad_state = torch.is_grad_enabled()
    m1, e1 = _facade_run(obs, controls, mean, cov)
    _, e2 = _facade_run(obs, controls, mean, cov)
    torch.testing.assert_close(e1, e2, atol=0, rtol=0)
    _, e3 = _facade_run(obs, controls, mean, cov, seed=4)
    assert not torch.equal(e1, e3)
    assert e1.shape == (2, 2, 3) and not e1.requires_grad
    assert m1.belief.particles.shape == (2, 300, 3)
    assert torch.is_grad_enabled() == grad_state
