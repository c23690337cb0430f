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


def _b1_inputs(n, m, d, device, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    lw = torch.log_softmax(torch.randn(n, m, generator=g, device=device), dim=1)
    ll = torch.randn(n, m, generator=g, device=device)
    particles = torch.randn(n, m, d, generator=g, device=device)
    uniforms = torch.rand(n, m, generator=g, device=device)
    return lw, ll, particles, uniforms


@pytest.mark.gpu
@pytest.mark.parametrize("n,m,d", [(16, 300, 3), (16, 100, 3), (2, 1, 2),
                                   (4, 1000, 2), (4, 1024, 2)])
def test_b1_kernel_matches_plain_version(cuda, n, m, d):
    args = _b1_inputs(n, m, d, cuda)
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


@pytest.mark.gpu
def test_b1_kernel_refuses_what_it_does_not_take(cuda):
    lw, ll, particles, uniforms = _b1_inputs(2, 8, 3, cuda)
    with pytest.raises(ValueError, match="contiguous"):
        pf_kernels.pf_update_and_resample(lw.t().contiguous().t(), ll, particles, uniforms)
    with pytest.raises(ValueError, match="float32"):
        pf_kernels.pf_update_and_resample(lw.double(), ll, particles, uniforms)
    wide = _b1_inputs(2, 8, 9, cuda)
    with pytest.raises(ValueError, match="D <= 8"):
        pf_kernels.pf_update_and_resample(*wide)


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
