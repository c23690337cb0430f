"""The host side of the cluster kernels B3 and B5, and a plain-PyTorch
rehearsal of their split-row tail, on the CPU.

B3 runs each trajectory on a thread-block cluster of one block per
64-particle tile; B5 splits each row over a cluster whose size grows with M.
The tests check those choices and the slices they give. (The C entries
report what they launch; the card tests hold these choices against them.)
The merge of the slices' partials (in rank order), the CDF offsets and the
two-level search run only on the card, so ``split_row_tail`` below
rehearses them in torch ops and holds the result against
``pf_update_and_resample_reference`` at ragged splits and against JAX's
``pf_update_and_resample`` (Pallas, interpret mode). It checks the
algorithm, not the kernel: it has none of the kernel's explicit rounding
operations and cannot catch a fault in the CUDA merge, which the card tests
of ``tests/test_torch_port_fused_gpu.py`` cover at the same ragged splits
(B3 at M=65 and 300, B5 at M=2,048 and beyond). It is test code only:
nothing on the port's path calls it.

Indices may differ only where a search target lies within TIE of a CDF
entry (the rehearsal sums the CDF in another order than ``torch.cumsum``).
"""

import math

import numpy as np
import pytest
import torch

from multimodalfilter_tpu.ops.pallas_pf import pf_update_and_resample as jax_tail
from multimodalfilter_tpu_torch.ops import fused_step, pf_kernels

TIE = 1e-6
EST_ATOL = 1e-6  # fp32 sums over at most 2,049 particles in two orders
LW_ATOL = 1e-5  # soft log-weights near -log M ~ -7.6 (one ulp 4.8e-7)


def kernel_slice(m, cluster):
    """B5's slice in ``csrc/pf_resample.cu`` (``slice_of``): ceil(M / C)
    rounded up to a multiple of 32."""
    return -(-m // cluster) + 31 & ~31


def split_row_tail(log_weights, log_liks, particles, uniforms, alpha, cluster, slice_):
    """The cluster row tail of ``csrc/pf_tail.cuh`` in torch ops (the
    algorithm, not the kernel's rounding): each of
    ``cluster`` slices of ``slice_`` slots computes its partials; every
    block merges them in rank order into the global max, sum, estimate,
    per-slice scales and CDF offsets; a target belongs to the first slice
    whose last CDF entry reaches it and is searched inside that slice.
    Returns (indices (N, M), log-weights (N, M), estimate (N, D))."""
    n, m, d = particles.shape
    f32 = torch.float32
    soft = alpha < 1.0
    uniform_part = torch.tensor((1.0 - alpha) / m if soft else 0.0, dtype=f32)
    alpha_t = torch.tensor(alpha if soft else 1.0, dtype=f32)
    out_idx = torch.empty((n, m), dtype=torch.long)
    out_lw = torch.empty((n, m), dtype=f32)
    est = torch.empty((n, d), dtype=f32)
    bounds = [(min(r * slice_, m), min((r + 1) * slice_, m)) for r in range(cluster)]
    assert all(b > a for a, b in bounds), "every slice non-empty"
    for row in range(n):
        logit = log_weights[row] + log_liks[row]
        # a. each slice's partials
        parts = []
        for a, b in bounds:
            mx = logit[a:b].max()
            e = torch.exp(logit[a:b] - mx)
            scan = torch.cumsum(e, 0)
            parts.append((mx, scan, scan[-1], (e[:, None] * particles[row, a:b]).sum(0)))
        # c. the merge, in rank order, as every block does it
        g = torch.stack([p[0] for p in parts]).max()
        ex = [torch.exp(p[0] - g) for p in parts]
        total = torch.zeros((), dtype=f32)
        acc = torch.zeros(d, dtype=f32)
        for p, e in zip(parts, ex):
            total = total + p[2] * e
            acc = acc + p[3] * e
        est[row] = acc / total
        scales = [alpha_t * (e / total) for e in ex]
        offsets = [torch.zeros((), dtype=f32)]
        entries = []
        for (a, b), p, f in zip(bounds, parts, scales):
            i1 = torch.arange(1, b - a + 1, dtype=f32)
            cdf = offsets[-1] + (f * p[1] + i1 * uniform_part)
            entries.append(cdf)
            offsets.append(cdf[-1])
        # d. two-level search: the slice, then inside it
        target = uniforms[row] * (offsets[-1] if soft else 1.0)
        last = torch.stack(offsets[1:])
        owner = torch.searchsorted(last, target, right=False)  # first r with last >= t
        idx = torch.full((m,), m - 1, dtype=torch.long)
        for r, (a, _) in enumerate(bounds):
            sel = owner == r
            idx[sel] = a + torch.searchsorted(entries[r], target[sel].contiguous(), right=False)
        out_idx[row] = idx.clamp_(max=m - 1)
        # e. the new weights
        if soft:
            lwn = logit - g - torch.log(total)
            q = alpha * (torch.exp(logit - g) / total) + uniform_part
            w = (lwn - torch.log(q))[out_idx[row]]
            out_lw[row] = w - (w.max() + torch.log(torch.exp(w - w.max()).sum()))
        else:
            out_lw[row] = -math.log(m)
    return out_idx, out_lw, est


def _inputs(n, m, d=3, seed=0):
    r = np.random.default_rng(seed)
    logits = r.normal(size=(n, m)).astype(np.float32)
    lw = (logits - np.log(np.exp(logits).sum(1, keepdims=True))).astype(np.float32)
    ll = r.normal(size=(n, m)).astype(np.float32)
    particles = r.normal(size=(n, m, d)).astype(np.float32)
    uniforms = r.uniform(size=(n, m)).astype(np.float32)
    return lw, ll, particles, uniforms


@pytest.mark.parametrize("m,cluster,blocks", [(1, 1, 16), (64, 1, 16), (65, 2, 32),
                                               (300, 5, 80), (512, 8, 128)])
def test_b3_cluster_is_one_block_per_64_particle_tile(m, cluster, blocks):
    assert fused_step.cluster_size(m) == cluster
    assert 16 * fused_step.cluster_size(m) == blocks  # N = 16 clusters
    assert fused_step.cluster_size(fused_step.FUSED_M_MAX) == 8  # the portable size


@pytest.mark.parametrize("m,cluster,slice_", [
    (1025, 4, 288), (2048, 4, 512), (4099, 4, 1056), (8191, 4, 2048), (8192, 6, 1376),
    (16384, 6, 2752), (20000, 6, 3360), (60000, 6, 10016)])
def test_b5_cluster_splits_rows_into_non_empty_slices(m, cluster, slice_):
    assert pf_kernels.b5_cluster_size(m) == cluster
    assert kernel_slice(m, cluster) == slice_
    assert (cluster - 1) * slice_ < m  # the last slice holds a slot


def test_b5_slices_are_never_empty_above_small_m():
    """Every M that B5 takes splits into the chosen number of non-empty
    slices (the C entry refuses an empty one)."""
    m = np.arange(pf_kernels.SMALL_M_MAX + 1, 200_000)
    c = np.where(m < 8192, 4, 6)
    assert all(pf_kernels.b5_cluster_size(int(x)) == y for x, y in zip(m[::97], c[::97]))
    s = (-(-m // c) + 31) & ~31
    assert ((c - 1) * s < m).all()


# B3's tiles of 64 (M = 65 over 2 blocks, 300 over 5) and B5's plan (2,049
# over 8 slices of 288, the last one 33).
@pytest.mark.parametrize("m,cluster,slice_,alpha", [
    (65, 2, 64, 1.0), (65, 2, 64, 0.5), (300, 5, 64, 1.0), (300, 5, 64, 0.9),
    (2049, 8, 288, 1.0), (2049, 8, 288, 0.5)])
def test_split_row_tail_matches_plain_version(m, cluster, slice_, alpha):
    args = [torch.from_numpy(a) for a in _inputs(2, m, seed=m + cluster)]
    if m > 1024:
        assert kernel_slice(m, cluster) == slice_
    idx, lw, est = split_row_tail(*args, alpha, cluster, slice_)
    rp, rlw, rest = pf_kernels.pf_update_and_resample_reference(*args, alpha=alpha)
    ridx, drawn = pf_kernels.source_slots(args[2], rp)
    assert drawn
    tie = pf_kernels.draw_gaps(args[0], args[1], args[3], alpha) <= TIE
    assert not ((idx != ridx) & ~tie).any()
    torch.testing.assert_close(est, rest, atol=EST_ATOL, rtol=0)
    expected = rlw if alpha >= 1.0 else pf_kernels.importance_weights(
        args[0], args[1], idx, alpha)
    torch.testing.assert_close(lw, expected, atol=LW_ATOL, rtol=0)


@pytest.mark.parametrize("alpha", [1.0, 0.5])
def test_split_row_tail_matches_pallas_kernel(alpha):
    lw, ll, particles, uniforms = _inputs(2, 2049, seed=7)
    jp, _, jest = jax_tail(lw, ll, particles, uniforms, alpha=alpha, interpret=True)
    args = [torch.from_numpy(a) for a in (lw, ll, particles, uniforms)]
    idx, _, est = split_row_tail(*args, alpha, 8, kernel_slice(2049, 8))
    jidx, drawn = pf_kernels.source_slots(args[2], torch.from_numpy(np.array(jp)))
    assert drawn
    tie = pf_kernels.draw_gaps(args[0], args[1], args[3], alpha) <= TIE
    assert not ((idx != jidx) & ~tie).any()
    np.testing.assert_allclose(est.numpy(), np.asarray(jest), atol=EST_ATOL, rtol=0)
