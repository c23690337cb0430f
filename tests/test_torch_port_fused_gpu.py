"""The port's remaining eval kernels on the card: B4 (soft resampling) and
B5 (large M) against their plain version, B3 (the whole eval loop) against
``fused_forward_reference``, and the serving route through
``StatefulFilter`` with ``MMF_TPU_FUSED_STEP=1``. Marked ``gpu``; each test
skips (inside a fixture) when no CUDA card is present.

This file imports only torch and the port, so it also runs on a machine
without JAX: ``python -m pytest --noconftest -p no:cacheprovider
tests/test_torch_port_fused_gpu.py``.

Indices may differ only where a search target lies within TIE of a CDF
entry (the kernels scan the CDF in another summation order)."""

import dataclasses

import numpy as np
import pytest
import torch

from multimodalfilter_tpu_torch.crossmodal import door_models as tdoor
from multimodalfilter_tpu_torch.ops import fused_step, pf_kernels
from multimodalfilter_tpu_torch.types import ParticleBelief

TIE = 1e-6
EST_ATOL = 1e-5  # fp32 sums over up to 20,000 particles in another order
# Soft log-weights near -log M (up to ~9.9), one fp32 ulp ~1e-6, after sums
# of M terms.
LW_ATOL = 2e-5
# B3: its log-likelihoods against the plain trunks' (fp32 sums of 64 terms
# through 16 layers in two orders), and its resampled particles against the
# plain tail's draws (the same source slot, rounded differently), each
# relative to its scale where that exceeds 1.
LL_RTOL = 1e-4
PARTICLE_ATOL = 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _tail_inputs(n, m, d, device, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    lw = torch.log_softmax(torch.randn(n, m, generator=g, device=device), dim=1)
    ll = torch.randn(n, m, generator=g, device=device)
    particles = torch.randn(n, m, d, generator=g, device=device)
    uniforms = torch.rand(n, m, generator=g, device=device)
    return lw, ll, particles, uniforms


@pytest.mark.gpu
@pytest.mark.parametrize("n,m,d,alpha,kernel", [
    (16, 300, 3, 0.9, "launch_b4"), (16, 1, 2, 0.9, "launch_b4"),
    (16, 1025, 3, 1.0, "launch_b5"), (16, 2048, 3, 0.5, "launch_b5"),
    (4, 16384, 3, 1.0, "launch_b5"), (2, 20000, 3, 0.5, "launch_b5"),
])
def test_b4_b5_match_plain_version(cuda, n, m, d, alpha, kernel):
    args = _tail_inputs(n, m, d, cuda, seed=m)
    counter = getattr(pf_kernels, kernel)
    before = counter.launches
    kp, klw, kest = pf_kernels.pf_update_and_resample(*args, alpha=alpha)
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    rp, rlw, rest = pf_kernels.pf_update_and_resample_reference(*args, alpha=alpha)
    kidx, drawn = pf_kernels.source_slots(args[2], kp)
    assert drawn
    tie = pf_kernels.draw_gaps(args[0], args[1], args[3], alpha) <= TIE
    assert not ((kidx != pf_kernels.source_slots(args[2], rp)[0]) & ~tie).any()
    torch.testing.assert_close(kest, rest, atol=EST_ATOL, rtol=0)
    if alpha >= 1.0:
        torch.testing.assert_close(klw, rlw, atol=0, rtol=0)
    else:
        # The weights the kernel's own draws carry (a draw that flips on a
        # tie changes its row's normaliser).
        torch.testing.assert_close(
            klw, pf_kernels.importance_weights(args[0], args[1], kidx, alpha),
            atol=LW_ATOL, rtol=0)


def _door_inputs(defn, t, n, m, device, seed=0, enabled=None):
    r = np.random.default_rng(seed)

    def arr(*shape):
        return torch.tensor(r.normal(size=shape), dtype=torch.float32, device=device)

    obs = {"image": arr(t, n, 32, 32), "gripper_pos": arr(t, n, 3),
           "gripper_sensors": arr(t, n, 7)}
    with torch.no_grad():
        features, ctrl = defn.encode_sequences(obs, arr(t, n, 7), enabled)
    eps = arr(t, n * m, 3)
    ops = fused_step.pack_operands(defn, features, ctrl, eps, enabled, m)
    belief = ParticleBelief(0.3 * arr(n, m, 3),
                            torch.full((n, m), -float(np.log(m)), device=device))
    uniforms = torch.rand((t, n, m), generator=torch.Generator(device=device).manual_seed(seed),
                          device=device)
    return ops, belief, uniforms


@pytest.mark.gpu
@pytest.mark.parametrize("name,n,m,enabled", [
    ("DoorCrossmodalParticleFilter", 4, 300, None),
    ("DoorCrossmodalParticleFilter", 2, 512, (True, False)),
    ("DoorParticleFilter", 1, 1, None),
    ("DoorUnimodalParticleFilter", 3, 64, None),
])
def test_b3_matches_plain_version_step_by_step(cuda, name, n, m, enabled):
    """Each step one launch from the plain run's belief: the kernel's
    log-likelihoods against the plain trunks'; given them, its estimate and
    draws against the plain tail's (relative to their scale where it
    exceeds 1)."""
    t = 4
    model = getattr(tdoor, name)(device=cuda, seed=0)
    defn = dataclasses.replace(model.definition, num_particles_eval=m)
    ops, belief, uniforms = _door_inputs(defn, t, n, m, cuda, enabled=enabled)
    before = fused_step.fused_forward_kernel.launches
    with torch.no_grad():
        for i in range(t):
            record = []
            rb, _ = fused_step.fused_forward_reference(ops.step(i), belief, uniforms[i:i + 1],
                                                       record=record)
            lls = torch.empty((1, n, m), device=cuda)
            kb, kest = fused_step.fused_forward_kernel(ops.step(i), belief, uniforms[i:i + 1],
                                                       log_liks_out=lls)
            torch.cuda.synchronize()
            lw, ll, u, new = record[0]
            assert (lls[0] - ll).abs().max() <= LL_RTOL * max(1.0, float(ll.abs().max()))
            ep, _, eest = pf_kernels.pf_update_and_resample_reference(lw, lls[0], new, u)
            torch.testing.assert_close(kest[0], eest, rtol=0,
                                       atol=EST_ATOL * max(1.0, float(eest.abs().max())))
            ok = pf_kernels.draw_gaps(lw, lls[0], u) > TIE
            scale = max(1.0, float(new.abs().max()))
            assert ((kb.particles - ep).abs().amax(-1)[ok] <= PARTICLE_ATOL * scale).all()
            belief = rb
    assert fused_step.fused_forward_kernel.launches == before + t


@pytest.mark.gpu
def test_b3_refuses_what_it_does_not_take(cuda):
    model = tdoor.DoorCrossmodalParticleFilter(device=cuda, seed=0)
    defn = dataclasses.replace(model.definition, num_particles_eval=8)
    ops, belief, uniforms = _door_inputs(defn, 2, 2, 8, cuda)
    with pytest.raises(ValueError, match="contiguous"):
        fused_step.fused_forward_kernel(ops, belief, uniforms.transpose(1, 2).contiguous()
                                        .transpose(1, 2))
    with pytest.raises(ValueError, match="must be"):
        fused_step.fused_forward_kernel(ops, belief, uniforms[:1])
    with pytest.raises(fused_step.Unsupported, match="M=513"):
        fused_step.pack_operands(defn, *(_door_features(defn, cuda)), None, 513)


def _door_features(defn, device):
    r = np.random.default_rng(0)
    obs = {"image": torch.zeros(1, 1, 32, 32, device=device),
           "gripper_pos": torch.zeros(1, 1, 3, device=device),
           "gripper_sensors": torch.zeros(1, 1, 7, device=device)}
    with torch.no_grad():
        features, ctrl = defn.encode_sequences(obs, torch.zeros(1, 1, 7, device=device))
    return features, ctrl, torch.tensor(r.normal(size=(1, 513, 3)), dtype=torch.float32,
                                        device=device)


@pytest.mark.gpu
def test_serving_route_launches_b3_once_per_loop(cuda, monkeypatch):
    monkeypatch.setenv("MMF_TPU_FUSED_STEP", "1")
    t, n = 5, 2
    model = tdoor.DoorCrossmodalParticleFilter(device=cuda, seed=0)
    assert model.definition.fused_step
    model.eval()
    r = np.random.default_rng(0)
    obs = {"image": r.normal(size=(t, n, 32, 32)).astype(np.float32),
           "gripper_pos": r.normal(size=(t, n, 3)).astype(np.float32),
           "gripper_sensors": r.normal(size=(t, n, 7)).astype(np.float32)}
    controls = r.normal(size=(t, n, 7)).astype(np.float32)
    model.initialize_beliefs(mean=np.zeros((n, 3), np.float32),
                             covariance=np.tile(np.eye(3, dtype=np.float32), (n, 1, 1)))
    before = (fused_step.fused_forward_kernel.launches, pf_kernels.launch_b1.launches)
    est = model.forward_loop(observations=obs, controls=controls)
    torch.cuda.synchronize()
    assert fused_step.packing_report() is None
    assert (fused_step.fused_forward_kernel.launches, pf_kernels.launch_b1.launches) == (
        before[0] + 1, before[1])
    assert est.shape == (t, n, 3) and torch.isfinite(est).all()
    assert model.belief.particles.shape == (n, 300, 3)
