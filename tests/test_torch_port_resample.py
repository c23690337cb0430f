"""The plain versions of the eval tails B4 (soft resampling) and B5 (large M)
against the JAX package's ``pf_update_and_resample`` (Pallas, interpret
mode) on the CPU, at the shapes of ``tests/test_pallas_pf.py``; and the
wrapper's choice of the plain version for CPU tensors.

Both sides get the same numpy inputs and uniforms. Resampled indices may
differ only where a search target lies within TIE of a CDF entry (the two
sides sum the CDF in different orders). At M = 2048 some draws land that
close whatever the seed, so each case checks the indices off ties and
asserts that ties are rare.
"""

import numpy as np
import pytest
import torch

from multimodalfilter_tpu.ops.pallas_pf import pf_update_and_resample as jax_tail
from multimodalfilter_tpu_torch.ops import pf_kernels

TIE = 1e-6  # fp32 CDFs summed in different orders differ by ~1e-7
# Estimates: fp32 sums over up to 2048 particles in two orders. Soft
# log-weights: log-normalised values near -log M ~ -7.6, where one fp32 ulp
# is 4.8e-7, after sums of M terms.
EST_ATOL = 1e-5
LW_ATOL = 1e-5


def _inputs(n, m, d=3, seed=0, lead=0.0):
    """Seeded tail inputs; `lead` > 0 raises one particle of row 0 that many
    nats above the rest."""
    r = np.random.default_rng(seed)
    logits = r.normal(size=(n, m)).astype(np.float32)
    lw = (logits - np.log(np.exp(logits).sum(1, keepdims=True))).astype(np.float32)
    ll = r.normal(size=(n, m)).astype(np.float32)
    ll[0, m // 3] += lead
    particles = r.normal(size=(n, m, d)).astype(np.float32)
    uniforms = r.uniform(size=(n, m)).astype(np.float32)
    return lw, ll, particles, uniforms


# (n, m, alpha, d, lead): B4 (JAX's _pf_soft_kernel), B5's multinomial and
# soft cases (JAX's _pf_kernel_chunked), then B4's edges: one slot, a row
# with one particle 80 nats ahead (the mixture's uniform part still draws
# the others), D = 8 at the largest M.
@pytest.mark.parametrize("n,m,alpha,d,lead", [
    pytest.param(3, 100, 0.7, 3, 0.0, id="3-100-0.7"),
    pytest.param(2, 2048, 1.0, 3, 0.0, id="2-2048-1.0"),
    pytest.param(2, 1536, 0.5, 3, 0.0, id="2-1536-0.5"),
    pytest.param(2, 1, 0.9, 3, 0.0, id="2-1-0.9"),
    pytest.param(2, 300, 0.9, 3, 80.0, id="2-300-0.9-lead80"),
    pytest.param(2, 1024, 0.5, 8, 0.0, id="2-1024-0.5-d8"),
])
def test_tail_reference_matches_pallas_kernel(n, m, alpha, d, lead):
    lw, ll, particles, uniforms = _inputs(n, m, d, seed=m, lead=lead)
    jp, jlw, jest = jax_tail(lw, ll, particles, uniforms, alpha=alpha, interpret=True)
    args = [torch.from_numpy(a) for a in (lw, ll, particles, uniforms)]
    tp, tlw, test = pf_kernels.pf_update_and_resample_reference(*args, alpha=alpha)
    tie = pf_kernels.draw_gaps(args[0], args[1], args[3], alpha).numpy() <= TIE
    # A uniform falls within TIE of one of its two neighbouring CDF entries
    # with chance ~2 * TIE * M: 0.4% at M = 2048.
    assert tie.mean() < 4 * TIE * m
    # Particles are distinct draws, so equal particles <=> equal indices.
    differs = (np.asarray(jp) != tp.numpy()).any(-1)
    assert not (differs & ~tie).any()
    np.testing.assert_allclose(np.asarray(jest), test.numpy(), atol=EST_ATOL, rtol=0)
    # A draw that flips on a tie changes its row's normaliser: compare the
    # soft weights on rows whose draws all agree.
    same = ~differs.any(1)
    assert same.any()
    np.testing.assert_allclose(np.asarray(jlw)[same], tlw.numpy()[same], atol=LW_ATOL, rtol=0)
    if alpha < 1.0:
        assert np.abs(np.log(np.exp(tlw.numpy()).sum(1))).max() < 1e-5


def test_soft_reference_keeps_the_importance_weights():
    """alpha < 1: the drawn particles carry w / q (log-normalised); alpha = 0
    draws uniformly and keeps the weights themselves."""
    lw, ll, particles, uniforms = (torch.from_numpy(a) for a in _inputs(2, 64, seed=3))
    _, out_lw, _ = pf_kernels.pf_update_and_resample_reference(
        lw, ll, particles, uniforms, alpha=0.0)
    upd = torch.log_softmax(lw + ll, dim=1)
    idx = (uniforms * 64).long().clamp_(max=63)  # uniform mixture: cdf = (j+1)/64
    expected = torch.log_softmax(torch.gather(upd, 1, idx), dim=1)
    torch.testing.assert_close(out_lw, expected, atol=1e-5, rtol=0)


@pytest.mark.parametrize("m,alpha", [(100, 0.7), (1025, 1.0), (1025, 0.5)])
def test_wrapper_takes_the_plain_version_on_cpu(m, alpha):
    args = [torch.from_numpy(a) for a in _inputs(2, m, seed=5)]
    counters = (pf_kernels.launch_b1, pf_kernels.launch_b4, pf_kernels.launch_b5)
    before = [c.launches for c in counters]
    out = pf_kernels.pf_update_and_resample(*args, alpha=alpha)
    ref = pf_kernels.pf_update_and_resample_reference(*args, alpha=alpha)
    for a, b in zip(out, ref):
        torch.testing.assert_close(a, b, atol=0, rtol=0)
    assert [c.launches for c in counters] == before


def test_draw_gaps_uses_the_soft_target():
    lw = torch.log(torch.tensor([[0.5, 0.5]]))
    ll = torch.zeros(1, 2)
    u = torch.tensor([[0.25, 0.7]])
    # multinomial: cdf (0.5, 1.0); soft alpha=0.5: mixture (0.5, 0.5) too,
    # target u * cdf_last = u.
    torch.testing.assert_close(pf_kernels.draw_gaps(lw, ll, u),
                               torch.tensor([[0.25, 0.2]]), atol=1e-6, rtol=0)
    torch.testing.assert_close(pf_kernels.draw_gaps(lw, ll, u, 0.5),
                               torch.tensor([[0.25, 0.2]]), atol=1e-6, rtol=0)

