"""The particle-filter eval step tail: B1, B4 and B5 (port of
``multimodalfilter_tpu/ops/pallas_pf.py::pf_update_and_resample``).

``pf_update_and_resample(lw, ll, particles, uniforms, *, alpha=1.0)`` fuses
the weight update, log-normalise, weighted-mean estimate (taken before
resampling), inverse-CDF resample from given uniforms and gather, and resets
the weights: to uniform (multinomial, ``alpha >= 1``), or to the
log-normalised importance weights of soft resampling (``alpha < 1``, a draw
from the mixture ``alpha * w + (1 - alpha) / M``). On CPU tensors it runs the
plain version ``pf_update_and_resample_reference``. On CUDA tensors it
launches one of the hand-written kernels of ``csrc/pf_resample.cu`` or
raises:

  B1 (``_pf_kernel``)          multinomial, M <= SMALL_M_MAX
  B4 (``_pf_soft_kernel``)     soft, M <= SMALL_M_MAX
  B5 (``_pf_kernel_chunked``)  either, M > SMALL_M_MAX (every M; the TPU's
                               kernel stops at 16,384)

Like the TPU kernels and unlike ``ops/resampling.py``, neither side divides
the CDF by its last entry: multinomial compares ``cdf < u``, soft
``cdf < u * cdf_last``.

``launch_b1.launches``, ``launch_b4.launches`` and ``launch_b5.launches``
count each kernel's launches.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from ._build import load_library

SMALL_M_MAX = 1024  # B1 and B4 up to here, B5 above
SHARED_CDF_M_MAX = 16384  # B5 keeps the CDF in shared memory up to here
MAX_D = 8


def resample_cdf(log_weights, log_liks, alpha: float = 1.0):
    """(distribution, inclusive CDF), both (N, M), that the tail draws
    from: the updated weights' probabilities (multinomial) or the mixture
    ``alpha * p + (1 - alpha) / M`` (soft). Not divided by the last entry."""
    lw = log_weights + log_liks
    e = torch.exp(lw - lw.amax(dim=1, keepdim=True))
    dist = e / e.sum(dim=1, keepdim=True)
    if alpha < 1.0:
        dist = alpha * dist + (1.0 - alpha) / dist.shape[1]
    return dist, torch.cumsum(dist, dim=1)


def tie_gaps(cdf, uniforms):
    """(N, M): distance from each uniform to its nearest CDF entry. A draw
    whose gap is below the summation-order error of two CDFs may pick a
    neighbouring index in another implementation (a tie)."""
    m = cdf.shape[1]
    u = uniforms.contiguous()
    hi = torch.searchsorted(cdf.contiguous(), u).clamp_(max=m - 1)
    lo = (hi - 1).clamp_(min=0)
    return torch.minimum(
        (torch.gather(cdf, 1, hi) - u).abs(), (torch.gather(cdf, 1, lo) - u).abs()
    )


def draw_gaps(log_weights, log_liks, uniforms, alpha: float = 1.0):
    """``tie_gaps`` of the tail's own search targets: ``u`` against the
    CDF of p, or ``u * cdf_last`` against the mixture's CDF."""
    _, cdf = resample_cdf(log_weights, log_liks, alpha)
    target = uniforms if alpha >= 1.0 else uniforms * cdf[:, -1:]
    return tie_gaps(cdf, target)


def pf_update_and_resample_reference(log_weights, log_liks, particles, uniforms,
                                     alpha: float = 1.0):
    """Plain torch version of B1 (alpha >= 1), B4 (alpha < 1) and B5 (any
    M). Returns (particles' (N, M, D), log_weights' (N, M), estimate
    (N, D))."""
    n, m, d = particles.shape
    lw = log_weights + log_liks
    lw_max = lw.amax(dim=1, keepdim=True)
    shifted = torch.exp(lw - lw_max)
    total = shifted.sum(dim=1, keepdim=True)
    probs = shifted / total
    estimate = torch.einsum("nm,nmd->nd", probs, particles)
    if alpha >= 1.0:
        cdf, target = torch.cumsum(probs, dim=1), uniforms
    else:
        mixture = alpha * probs + (1.0 - alpha) / m
        cdf = torch.cumsum(mixture, dim=1)
        target = uniforms * mixture.sum(dim=1, keepdim=True)
    # Left-side search: the first index with cdf >= target, i.e. #(cdf < target).
    idx = torch.searchsorted(cdf, target.contiguous(), right=False).clamp_(max=m - 1)
    out = torch.gather(particles, 1, idx[:, :, None].expand(n, m, d))
    if alpha >= 1.0:
        out_lw = torch.full((n, m), -math.log(m), dtype=particles.dtype,
                            device=particles.device)
    else:
        out_lw = importance_weights(log_weights, log_liks, idx, alpha)
    return out, out_lw, estimate


def importance_weights(log_weights, log_liks, indices, alpha: float):
    """Soft resampling's new log-weights (N, M) for the draws `indices`:
    the normalised log-weights minus the mixture's log at each drawn slot,
    log-normalised (pallas_pf.py:195-214)."""
    lw = log_weights + log_liks
    lw_max = lw.amax(dim=1, keepdim=True)
    shifted = torch.exp(lw - lw_max)
    total = shifted.sum(dim=1, keepdim=True)
    lw_norm = lw - lw_max - torch.log(total)
    mixture = alpha * (shifted / total) + (1.0 - alpha) / lw.shape[1]
    new_lw = torch.gather(lw_norm, 1, indices) - torch.gather(torch.log(mixture), 1, indices)
    nl_max = new_lw.amax(dim=1, keepdim=True)
    nl_total = torch.exp(new_lw - nl_max).sum(dim=1, keepdim=True)
    return new_lw - nl_max - torch.log(nl_total)


def source_slots(particles, out):
    """(N, M) source slot of each output particle of a tail, found by
    matching all its coordinates (one float64 key per particle: random
    first coordinates alone repeat at M = 16,384), and whether every output
    is a draw of the input. For checks of the kernels."""
    d = particles.shape[2]
    w = torch.tensor([1.0, 1.6180339887498949, 2.718281828459045, 3.14159265358979,
                      1.4142135623730951, 1.7320508075688772, 2.23606797749979,
                      2.6457513110645907][:d], dtype=torch.float64, device=particles.device)
    keys, order = (particles.double() * w).sum(-1).sort(dim=1)
    pos = torch.searchsorted(keys, (out.double() * w).sum(-1).contiguous())
    idx = order.gather(1, pos.clamp_(max=keys.shape[1] - 1))
    return idx, torch.equal(torch.gather(particles, 1, idx[:, :, None].expand(-1, -1, d)), out)


@functools.cache
def _kernels():
    lib = load_library("pf_resample")
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    # Every pointer and the stream as c_void_p: without argtypes ctypes would
    # pass a Python int as a 32-bit int and cut the pointer.
    b1 = lib.pf_update_and_resample_f32
    b1.argtypes = [ptr] * 7 + [i32, i32, i32, ptr]
    b4 = lib.pf_soft_resample_f32
    b4.argtypes = [ptr] * 7 + [i32, i32, i32, f32, ptr]
    b5 = lib.pf_resample_large_f32
    b5.argtypes = [ptr] * 8 + [i32, i32, i32, f32, ptr]
    for fn in (b1, b4, b5):
        fn.restype = ctypes.c_int
    return {"b1": b1, "b4": b4, "b5": b5}


def _check_cuda_inputs(log_weights, log_liks, particles, uniforms):
    tensors = (log_weights, log_liks, particles, uniforms)
    device = particles.device
    if device.type != "cuda":
        raise ValueError(f"the tail kernel needs CUDA tensors, got {device}")
    for x in tensors:
        if x.device != device:
            raise ValueError(f"inputs on several devices: {x.device} and {device}")
        if x.dtype != torch.float32:
            raise ValueError(f"the tail kernels take float32, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError("the tail kernels take contiguous tensors")
    if particles.ndim != 3:
        raise ValueError(f"particles must be (N, M, D), got {tuple(particles.shape)}")
    n, m, d = particles.shape
    for name, x in (("log_weights", log_weights), ("log_liks", log_liks),
                    ("uniforms", uniforms)):
        if tuple(x.shape) != (n, m):
            raise ValueError(f"{name} must be {(n, m)}, got {tuple(x.shape)}")
    if not 1 <= d <= MAX_D or n < 1 or m < 1:
        raise ValueError(f"the tail kernels take N, M >= 1 and 1 <= D <= {MAX_D}, "
                         f"got {(n, m, d)}")


def _launch(name, args, *extra):
    log_weights, log_liks, particles, uniforms = args
    n, m, d = particles.shape
    out = torch.empty_like(particles)
    out_lw = torch.empty_like(log_weights)
    est = torch.empty((n, d), dtype=particles.dtype, device=particles.device)
    pointers = [log_weights.data_ptr(), log_liks.data_ptr(), uniforms.data_ptr(),
                particles.data_ptr(), out.data_ptr(), out_lw.data_ptr(), est.data_ptr()]
    scratch = None
    if name == "b5":
        # Above SHARED_CDF_M_MAX the kernel keeps each row's CDF here.
        if m > SHARED_CDF_M_MAX:
            scratch = torch.empty((n, m), dtype=torch.float32, device=particles.device)
        pointers.append(None if scratch is None else scratch.data_ptr())
    with torch.cuda.device(particles.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _kernels()[name](*pointers, n, m, d, *extra, stream)
    if rc != 0:
        raise RuntimeError(f"{name.upper()} kernel launch failed: cudaError {rc}")
    return out, out_lw, est


def launch_b1(*args):
    """B1 on CUDA tensors: multinomial, M <= SMALL_M_MAX."""
    out = _launch("b1", args)
    launch_b1.launches += 1
    return out


def launch_b4(*args, alpha: float):
    """B4 on CUDA tensors: soft (alpha < 1), M <= SMALL_M_MAX."""
    out = _launch("b4", args, alpha)
    launch_b4.launches += 1
    return out


def launch_b5(*args, alpha: float):
    """B5 on CUDA tensors: either mode, any M (the tail above SMALL_M_MAX)."""
    out = _launch("b5", args, alpha)
    launch_b5.launches += 1
    return out


launch_b1.launches = launch_b4.launches = launch_b5.launches = 0


def pf_update_and_resample(log_weights, log_liks, particles, uniforms, *,
                           alpha: float = 1.0):
    """Fused PF measurement update + estimate + resample (eval).

    Args (JAX layout): log_weights, log_liks, uniforms (N, M); particles
    (N, M, D); alpha < 1 selects soft resampling. Returns (particles'
    (N, M, D), log_weights' (N, M), estimate (N, D)).
    """
    tensors = (log_weights, log_liks, particles, uniforms)
    if all(x.device.type == "cpu" for x in tensors):
        return pf_update_and_resample_reference(*tensors, alpha=alpha)
    _check_cuda_inputs(*tensors)
    m = particles.shape[1]
    if m > SMALL_M_MAX:
        return launch_b5(*tensors, alpha=alpha)
    if alpha < 1.0:
        return launch_b4(*tensors, alpha=alpha)
    return launch_b1(*tensors)
