"""The port on the card: the B1 kernel against its plain version, and the
door crossmodal PF's eval loop through the kernel. Marked ``gpu``; each test
skips (inside a fixture) when no CUDA card is present.

This file imports only torch and the port, so it also runs on a machine
without JAX: ``python -m pytest --noconftest -p no:cacheprovider
tests/test_torch_port_gpu.py``.

Indices may differ only where a uniform lies within TIE of a CDF entry (the
kernel scans the CDF in another summation order than ``torch.cumsum``)."""

import numpy as np
import pytest
import torch

from multimodalfilter_tpu_torch.crossmodal import door_models as tdoor
from multimodalfilter_tpu_torch.ops import pf_kernels

TIE = 1e-6


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _b1_inputs(n, m, d, device, seed=0, lead=0.0):
    """Seeded tail inputs; `lead` > 0 raises one particle of row 0 that many
    nats above the rest (the CDF flat past it)."""
    g = torch.Generator(device=device).manual_seed(seed)
    lw = torch.log_softmax(torch.randn(n, m, generator=g, device=device), dim=1)
    ll = torch.randn(n, m, generator=g, device=device)
    ll[0, m // 3] += lead
    particles = torch.randn(n, m, d, generator=g, device=device)
    uniforms = torch.rand(n, m, generator=g, device=device)
    return lw, ll, particles, uniforms


# (n, m, d, lead): the main path's shapes, then the edges of the one-pass
# kernel: whole and ragged warps (M = 31, 32, 33), 1, 2 and 4 slots a
# thread (M = 256, 300, 1023, 1024), one and 512 rows, D = 8 at M = 1024,
# and a row with one particle 80 nats ahead.
@pytest.mark.gpu
@pytest.mark.parametrize("n,m,d,lead", [
    pytest.param(16, 300, 3, 0.0, id="16-300-3"), pytest.param(16, 100, 3, 0.0, id="16-100-3"),
    pytest.param(2, 1, 2, 0.0, id="2-1-2"), pytest.param(4, 1000, 2, 0.0, id="4-1000-2"),
    pytest.param(4, 1024, 2, 0.0, id="4-1024-2"),
    pytest.param(16, 31, 3, 0.0, id="16-31-3"), pytest.param(16, 32, 3, 0.0, id="16-32-3"),
    pytest.param(16, 33, 3, 0.0, id="16-33-3"), pytest.param(16, 256, 3, 0.0, id="16-256-3"),
    pytest.param(16, 1023, 3, 0.0, id="16-1023-3"), pytest.param(1, 300, 3, 0.0, id="1-300-3"),
    pytest.param(512, 100, 3, 0.0, id="512-100-3"), pytest.param(16, 1024, 8, 0.0, id="16-1024-8"),
    pytest.param(16, 300, 3, 80.0, id="16-300-3-lead80"),
])
def test_b1_kernel_matches_plain_version(cuda, n, m, d, lead):
    args = _b1_inputs(n, m, d, cuda, lead=lead)
    before = pf_kernels.launch_b1.launches
    kp, klw, kest = pf_kernels.pf_update_and_resample(*args)
    torch.cuda.synchronize()
    assert pf_kernels.launch_b1.launches == before + 1
    rp, rlw, rest = pf_kernels.pf_update_and_resample_reference(*args)
    _, cdf = pf_kernels.resample_cdf(args[0], args[1])
    ok = pf_kernels.tie_gaps(cdf, args[3]) > TIE
    assert torch.equal(kp[ok], rp[ok])
    torch.testing.assert_close(kest, rest, atol=1e-5, rtol=0)
    torch.testing.assert_close(klw, rlw, atol=0, rtol=0)
    if lead:
        assert torch.equal(kp[0][ok[0]], args[2][0, m // 3].expand(m, d)[ok[0]])


@pytest.mark.gpu
def test_b1_kernel_refuses_what_it_does_not_take(cuda):
    """B1 and B4 through the wrapper raise on every input they refuse
    (non-contiguous, float64, D = 9, several devices, CPU particles),
    count nothing then, and count each launch once."""
    lw, ll, particles, uniforms = _b1_inputs(4, 40, 3, cuda)
    refused = {
        "contiguous": (lw.t().contiguous().t(), ll, particles, uniforms),
        "float32": (lw, ll.double(), particles, uniforms),
        "D <= 8": _b1_inputs(4, 40, 9, cuda),
        "several devices": (lw, ll, particles, uniforms.cpu()),
        "needs CUDA tensors": (lw.cpu(), ll, particles.cpu(), uniforms),
    }
    for alpha, count in ((1.0, pf_kernels.launch_b1), (0.9, pf_kernels.launch_b4)):
        before = count.launches
        for match, args in refused.items():
            with pytest.raises(ValueError, match=match):
                pf_kernels.pf_update_and_resample(*args, alpha=alpha)
        assert count.launches == before
        for _ in range(3):
            pf_kernels.pf_update_and_resample(lw, ll, particles, uniforms, alpha=alpha)
        torch.cuda.synchronize()
        assert count.launches == before + 3


@pytest.mark.gpu
def test_crossmodal_pf_eval_loop_launches_b1_once_per_step(cuda):
    t, n = 4, 2
    model = tdoor.DoorCrossmodalParticleFilter(device=cuda, seed=0)
    model.eval()
    r = np.random.default_rng(0)
    obs = {
        "image": r.normal(size=(t, n, 32, 32)).astype(np.float32),
        "gripper_pos": r.normal(size=(t, n, 3)).astype(np.float32),
        "gripper_sensors": r.normal(size=(t, n, 7)).astype(np.float32),
    }
    controls = r.normal(size=(t, n, 7)).astype(np.float32)
    model.initialize_beliefs(mean=np.zeros((n, 3), np.float32),
                             covariance=np.tile(np.eye(3, dtype=np.float32), (n, 1, 1)))
    before = pf_kernels.launch_b1.launches
    est = model.forward_loop(observations=obs, controls=controls)
    torch.cuda.synchronize()
    assert pf_kernels.launch_b1.launches == before + t
    assert est.shape == (t, n, 3) and torch.isfinite(est).all()
