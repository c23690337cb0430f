"""The port's training path on the card: the B2 kernels (forward B2f,
backward B2b) against their plain versions, the autograd Function against
autograd of the plain forward, what the kernels refuse, and one
``train_e2e`` epoch of the door crossmodal PF through them. Marked ``gpu``;
each test skips (inside a fixture) when no CUDA card is present.

This file imports only torch, numpy and the port, so it also runs on a
machine without JAX: ``python -m pytest --noconftest -p no:cacheprovider
tests/test_torch_port_train_gpu.py``.
"""

import numpy as np
import pytest
import torch

from multimodalfilter_tpu_torch.crossmodal import door_models as tdoor
from multimodalfilter_tpu_torch.crossmodal import train_helpers
from multimodalfilter_tpu_torch.experiments import Buddy
from multimodalfilter_tpu_torch.ops import pf_estimate, pf_kernels
from multimodalfilter_tpu_torch.types import Trajectory

# fp32 sums over M in a warp-shuffle tree against torch's reductions, and
# expf/logf against torch's exp/log; values are O(1-10) and M reaches 5000.
ATOL = 1e-5
# (N, M, D, lead): the main path's shapes; the edges of the kernels'
# register slots (M <= 32, 64, 128, 256 slots a row, 1, 2, 4 and 8 a lane)
# and of the looped instance above; every D <= 8; one row; a row whose slot
# M // 3 leads the rest by `lead` nats.
SHAPES = [(32, 30, 3, 0.0), (512, 30, 3, 0.0), (16, 300, 3, 0.0), (3, 1, 2, 0.0),
          (4, 1000, 8, 0.0), (2, 5000, 3, 0.0),
          (16, 31, 3, 0.0), (16, 32, 3, 0.0), (16, 33, 3, 0.0), (16, 64, 3, 0.0),
          (16, 65, 3, 0.0), (16, 128, 3, 0.0), (16, 129, 3, 0.0), (16, 256, 3, 0.0),
          (16, 257, 3, 0.0), (16, 256, 8, 0.0), (16, 257, 8, 0.0),
          (8, 30, 1, 0.0), (8, 30, 2, 0.0), (8, 30, 4, 0.0), (8, 30, 5, 0.0),
          (8, 30, 6, 0.0), (8, 30, 7, 0.0), (8, 30, 8, 0.0), (8, 100, 5, 0.0),
          (1, 30, 3, 0.0), (1, 1, 1, 0.0), (512, 100, 3, 0.0),
          (32, 30, 3, 80.0), (4, 1000, 3, 80.0)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(n, m, d, device, seed=0, lead=0.0):
    g = torch.Generator(device=device).manual_seed(seed)
    lw = torch.log_softmax(torch.randn(n, m, generator=g, device=device), dim=1)
    ll = torch.randn(n, m, generator=g, device=device)
    ll[0, m // 3] += lead
    particles = torch.randn(n, m, d, generator=g, device=device)
    g_lw = torch.randn(n, m, generator=g, device=device)
    g_est = torch.randn(n, d, generator=g, device=device)
    return lw, ll, particles, g_lw, g_est


@pytest.mark.gpu
@pytest.mark.parametrize("n,m,d,lead", SHAPES)
def test_b2_kernels_match_plain_versions(cuda, n, m, d, lead):
    lw, ll, particles, g_lw, g_est = _inputs(n, m, d, cuda, lead=lead)
    fwd, bwd = pf_estimate.pf_update_estimate_fwd, pf_estimate.pf_update_estimate_bwd
    before = (fwd.launches, bwd.launches)
    klw, kest = fwd(lw, ll, particles)
    torch.cuda.synchronize()
    rlw, rest = pf_estimate.pf_update_estimate_reference(lw, ll, particles)
    torch.testing.assert_close(klw, rlw, atol=ATOL, rtol=0)
    torch.testing.assert_close(kest, rest, atol=ATOL, rtol=0)

    kgs, kgx = bwd(rlw, particles, rest, g_lw, g_est)
    torch.cuda.synchronize()
    rgs, rgx = pf_estimate.pf_update_estimate_backward_reference(
        rlw, particles, rest, g_lw, g_est)
    torch.testing.assert_close(kgs, rgs, atol=ATOL, rtol=0)
    torch.testing.assert_close(kgx, rgx, atol=ATOL, rtol=0)
    assert (fwd.launches, bwd.launches) == (before[0] + 1, before[1] + 1)

    # An absent g_lw' (a null pointer to the kernel) is read as zeros.
    args = [x.clone().requires_grad_() for x in (lw, ll, particles)]
    with torch.enable_grad():
        _, est = pf_estimate.pf_update_estimate(*args)
        got = torch.autograd.grad((est * g_est).sum(), args)
    torch.cuda.synchronize()
    kest = est.detach()
    zs, zx = pf_estimate.pf_update_estimate_backward_reference(
        klw, particles, kest, torch.zeros_like(g_lw), g_est)
    for a, b in zip(got, (zs, zs, zx)):
        torch.testing.assert_close(a, b, atol=ATOL, rtol=0)
    assert (fwd.launches, bwd.launches) == (before[0] + 2, before[1] + 2)


@pytest.mark.gpu
@pytest.mark.parametrize("n,m,d", [(32, 30, 3), (2, 5000, 3)])
def test_b2_function_gradients_match_autograd_of_plain_forward(cuda, n, m, d):
    lw, ll, particles, g_lw, g_est = _inputs(n, m, d, cuda, seed=1)
    grads = []
    for fn in (pf_estimate.pf_update_estimate, pf_estimate.pf_update_estimate_reference):
        args = [x.clone().requires_grad_() for x in (lw, ll, particles)]
        with torch.enable_grad():
            out_lw, est = fn(*args)
            grads.append(torch.autograd.grad(
                (out_lw * g_lw).sum() + (est * g_est).sum(), args))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, atol=ATOL, rtol=0)


@pytest.mark.gpu
def test_b2_kernels_refuse_what_they_do_not_take(cuda):
    lw, ll, particles, g_lw, g_est = _inputs(2, 8, 3, cuda)
    fwd, bwd = pf_estimate.pf_update_estimate_fwd, pf_estimate.pf_update_estimate_bwd
    with pytest.raises(ValueError, match="contiguous"):
        fwd(lw.t().contiguous().t(), ll, particles)
    with pytest.raises(ValueError, match="float32"):
        fwd(lw, ll.double(), particles)
    wide = torch.randn(2, 8, 9, device=cuda)
    with pytest.raises(ValueError, match="D <= 8"):
        fwd(lw, ll, wide)
    with pytest.raises(ValueError, match="contiguous"):
        bwd(lw, particles, g_est, g_lw, g_est.t().contiguous().t())
    with pytest.raises(ValueError, match="float32"):
        bwd(lw, particles.double(), g_est, g_lw, g_est)


@pytest.mark.gpu
def test_train_e2e_epoch_launches_b2_every_step(cuda, tmp_path):
    b, seq_len, m = 4, 5, 30
    r = np.random.default_rng(0)
    trajectories = []
    for _ in range(2):
        t = 20
        obs = {"image": r.normal(size=(t, 32, 32)).astype(np.float32),
               "gripper_pos": r.normal(size=(t, 3)).astype(np.float32),
               "gripper_sensors": r.normal(size=(t, 7)).astype(np.float32)}
        trajectories.append(Trajectory(r.normal(size=(t, 3)).astype(np.float32), obs,
                                       r.normal(size=(t, 7)).astype(np.float32)))
    model = tdoor.DoorCrossmodalParticleFilter(device=cuda, seed=0)
    assert model.definition.num_particles_train == m
    buddy = Buddy("gpu", model, log_dir=str(tmp_path))
    train_helpers.configure(buddy=buddy, trajectories=trajectories)
    counters = (pf_estimate.pf_update_estimate_fwd, pf_estimate.pf_update_estimate_bwd,
                pf_kernels.launch_b1)
    before = [c.launches for c in counters]
    loss = train_helpers.train_e2e(subsequence_length=seq_len, epochs=1, batch_size=b)
    torch.cuda.synchronize()
    steps = buddy.optimizer_steps
    assert steps == (2 * (20 // seq_len)) // b and np.isfinite(loss)
    launched = [c.launches - x for c, x in zip(counters, before)]
    assert launched == [steps * (seq_len - 1), steps * (seq_len - 1), 0]
