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
                               kernel stops at 16,384), each row split over
                               a thread-block cluster of
                               ``b5_cluster_size(M)`` blocks

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
from typing import NamedTuple

import torch

from ._build import load_library

SMALL_M_MAX = 1024  # B1 and B4 up to here, B5 above
MAX_D = 8


def b5_cluster_size(m: int) -> int:
    """B5's blocks per row at M particles: 4 below 8,192, 6 from there on,
    the fastest of 2-8 on the H100 at M = 2,048 and 16,384 with N = 16
    rows (PERF.md; other N were not measured). Clusters of 7 and 8 fit
    only 15 at once there, so N = 16 would need a second wave."""
    return 4 if m < 8192 else 6


class B5Launch(NamedTuple):
    """What B5's C entry launches for N rows of M: ``cluster`` blocks a
    row, ``blocks`` in all, whether the rows take the strided kernel (its
    scans in a device-memory scratch), and how many such clusters the card
    holds at once (``cudaOccupancyMaxActiveClusters``)."""

    cluster: int
    blocks: int
    strided: bool
    max_active_clusters: int


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


class _Entries:
    """The C entry points of ``csrc/pf_resample.cu``, bound once, at the
    first launch (building the library if needed), and ``stream(index)``,
    the current stream of a device as a raw handle (the call Triton's and
    Inductor's launchers make: no ``torch.cuda.Stream`` object)."""

    b1 = b4 = b5 = b5_plan = stream = None

    @classmethod
    def bind(cls):
        cls.stream = torch._C._cuda_getCurrentRawStream
        lib = load_library("pf_resample")
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        # Every pointer and the stream as c_void_p: without argtypes ctypes
        # would pass a Python int as a 32-bit int and cut the pointer.
        specs = {"b1": ("pf_update_and_resample_f32", [ptr] * 7 + [i32] * 3 + [ptr]),
                 "b4": ("pf_soft_resample_f32", [ptr] * 7 + [i32] * 3 + [f32, ptr]),
                 "b5": ("pf_resample_large_f32", [ptr] * 8 + [i32] * 4 + [f32, ptr]),
                 "b5_plan": ("pf_resample_large_plan", [i32] * 4 + [ctypes.POINTER(i32)] * 3)}
        for key, (symbol, argtypes) in specs.items():
            fn = getattr(lib, symbol)
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
            setattr(cls, key, fn)
        return cls


def _b5_plan(n: int, m: int, cluster: int, soft: bool, occupancy: bool):
    vals = [ctypes.c_int(0) for _ in range(3)]
    refs = [ctypes.byref(v) for v in vals]
    rc = (_Entries.b5_plan or _Entries.bind().b5_plan)(n, m, cluster, int(soft), *refs[:2],
                                                       refs[2] if occupancy else None)
    if rc != 0:
        raise RuntimeError(f"B5 launch plan failed: cudaError {rc}")
    return B5Launch(cluster, vals[0].value, bool(vals[1].value), vals[2].value)


def b5_launch(n: int, m: int, alpha: float = 1.0) -> B5Launch:
    """B5's launch for N rows of M, as the C entry sets it up. Needs the
    card."""
    return _b5_plan(n, m, b5_cluster_size(m), alpha < 1.0, occupancy=True)


@functools.cache
def _b5_strided(m: int, cluster: int) -> bool:
    return _b5_plan(1, m, cluster, False, occupancy=False).strided


def _check_cuda_inputs(log_weights, log_liks, particles, uniforms) -> int:
    """Raises unless the four inputs are float32, contiguous, on one CUDA
    device and of the tails' shapes (N, M) and (N, M, D), 1 <= D <= MAX_D.
    Returns the device's index. One pass of cheap reads; which rule failed
    is worked out only on failure."""
    index = particles.get_device()
    f32 = torch.float32
    if (particles.is_cuda and particles.dim() == 3
            and log_weights.get_device() == index and log_liks.get_device() == index
            and uniforms.get_device() == index
            and log_weights.dtype is f32 and log_liks.dtype is f32
            and particles.dtype is f32 and uniforms.dtype is f32
            and log_weights.is_contiguous() and log_liks.is_contiguous()
            and particles.is_contiguous() and uniforms.is_contiguous()):
        n, m, d = particles.shape
        if (log_weights.shape == log_liks.shape == uniforms.shape == (n, m)
                and 1 <= d <= MAX_D and n >= 1 and m >= 1):
            return index
    _refuse(log_weights, log_liks, particles, uniforms)


def _refuse(log_weights, log_liks, particles, uniforms):
    """Raises the error for inputs ``_check_cuda_inputs`` refused."""
    tensors = (log_weights, log_liks, particles, uniforms)
    if not particles.is_cuda:
        raise ValueError(f"the tail kernel needs CUDA tensors, got {particles.device}")
    for x in tensors:
        if x.device != particles.device:
            raise ValueError(f"inputs on several devices: {x.device} and {particles.device}")
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
    raise ValueError(f"the tail kernels take N, M >= 1 and 1 <= D <= {MAX_D}, got {(n, m, d)}")


def _launch(entry, name, index, log_weights, log_liks, particles, uniforms, *extra,
            cluster: int = 0):
    """Allocates the outputs and calls the C entry `entry` on the current
    stream of device `index`, which the inputs (checked) lie on."""
    n, m, d = particles.shape
    out = torch.empty_like(particles)
    out_lw = torch.empty_like(log_weights)
    est = particles.new_empty((n, d))
    pointers = (log_weights.data_ptr(), log_liks.data_ptr(), uniforms.data_ptr(),
                particles.data_ptr(), out.data_ptr(), out_lw.data_ptr(), est.data_ptr())
    if cluster:
        # Rows that take B5's strided kernel keep their scans here.
        scratch = None
        if _b5_strided(m, cluster):
            scratch = torch.empty((n, m), dtype=torch.float32, device=particles.device)
        pointers += (None if scratch is None else scratch.data_ptr(),)
        extra = (cluster, *extra)
    if index == torch.cuda.current_device():
        rc = entry(*pointers, n, m, d, *extra, _Entries.stream(index))
    else:
        with torch.cuda.device(index):
            rc = entry(*pointers, n, m, d, *extra, _Entries.stream(index))
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")
    return out, out_lw, est


def launch_b1(log_weights, log_liks, particles, uniforms, *, index: int = None):
    """B1 on CUDA tensors: multinomial, M <= SMALL_M_MAX. `index` is the
    device that ``_check_cuda_inputs`` returned for them; without it the
    inputs are checked here."""
    if index is None:
        index = _check_cuda_inputs(log_weights, log_liks, particles, uniforms)
    out = _launch(_Entries.b1 or _Entries.bind().b1, "B1", index,
                  log_weights, log_liks, particles, uniforms)
    launch_b1.launches += 1
    return out


def launch_b4(log_weights, log_liks, particles, uniforms, *, alpha: float,
              index: int = None):
    """B4 on CUDA tensors: soft (alpha < 1), M <= SMALL_M_MAX."""
    if index is None:
        index = _check_cuda_inputs(log_weights, log_liks, particles, uniforms)
    out = _launch(_Entries.b4 or _Entries.bind().b4, "B4", index,
                  log_weights, log_liks, particles, uniforms, alpha)
    launch_b4.launches += 1
    return out


def launch_b5(log_weights, log_liks, particles, uniforms, *, alpha: float,
              index: int = None):
    """B5 on CUDA tensors: either mode, any M (the tail above SMALL_M_MAX),
    in clusters of ``b5_cluster_size(M)`` blocks a row. A cluster the card
    refuses raises."""
    args = (log_weights, log_liks, particles, uniforms)
    out = _launch_b5_in_clusters(args, alpha, b5_cluster_size(particles.shape[1]), index)
    launch_b5.launches += 1
    return out


def _launch_b5_in_clusters(args, alpha: float, cluster: int, index: int = None):
    """B5 in clusters of ``cluster`` blocks a row, uncounted: for the
    refused-cluster test and ``cluster_sweep.py``."""
    if index is None:
        index = _check_cuda_inputs(*args)
    return _launch(_Entries.b5 or _Entries.bind().b5, "B5", index, *args, alpha,
                   cluster=cluster)


launch_b1.launches = launch_b4.launches = launch_b5.launches = 0


def pf_update_and_resample(log_weights, log_liks, particles, uniforms, *,
                           alpha: float = 1.0):
    """Fused PF measurement update + estimate + resample (eval).

    Args (JAX layout): log_weights, log_liks, uniforms (N, M); particles
    (N, M, D); alpha < 1 selects soft resampling. Returns (particles'
    (N, M, D), log_weights' (N, M), estimate (N, D)).
    """
    if not particles.is_cuda and all(x.device.type == "cpu" for x in
                                     (log_weights, log_liks, particles, uniforms)):
        return pf_update_and_resample_reference(log_weights, log_liks, particles, uniforms,
                                                alpha=alpha)
    index = _check_cuda_inputs(log_weights, log_liks, particles, uniforms)
    if particles.shape[1] > SMALL_M_MAX:
        return launch_b5(log_weights, log_liks, particles, uniforms, alpha=alpha, index=index)
    if alpha < 1.0:
        return launch_b4(log_weights, log_liks, particles, uniforms, alpha=alpha, index=index)
    return launch_b1(log_weights, log_liks, particles, uniforms, index=index)
