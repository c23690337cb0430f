"""The particle-filter train step tail, B2, with its gradient (port of
``multimodalfilter_tpu/ops/pallas_pf.py::pf_update_estimate``).

``pf_update_estimate(log_weights, log_liks, particles)`` returns the
log-normalised weights ``lw' = s - logsumexp(s)`` of ``s = log_weights +
log_liks`` and the weighted-mean estimate ``sum_m exp(lw'_m) x_m``, with no
resampling, so that gradients flow through the weights during BPTT. On CUDA
tensors it is a ``torch.autograd.Function`` whose forward launches the B2f
kernel and whose backward launches the B2b kernel (``csrc/pf_estimate.cu``);
either raises on what the kernels do not take. On CPU tensors it runs the
plain version ``pf_update_estimate_reference``, which autograd
differentiates. ``pf_update_estimate_backward_reference`` is the closed-form
backward in torch ops, the plain version of B2b.

``pf_update_estimate_fwd.launches`` and ``pf_update_estimate_bwd.launches``
count kernel launches.
"""

from __future__ import annotations

import ctypes

import torch
from torch.autograd.function import once_differentiable

from ._build import load_library

MAX_D = 8
# Batch rows (one warp each) a block of B2f and B2b. Of 1, 2, 4 and 8 on the
# H100 at M = 30, four was within 0.04 us of the fastest at N = 32 (the
# training curriculum's batch) in four sweeps; at N = 512 eight was up to
# 0.1 us faster in three of them and 0.1 us slower in one (PERF.md;
# chip_smoke.py times the sweep).
ROWS_PER_BLOCK = 4


def pf_update_estimate_reference(log_weights, log_liks, particles):
    """Plain torch version of B2's forward. Returns (log_weights' (N, M),
    estimate (N, D))."""
    lw = log_weights + log_liks
    lw = lw - torch.logsumexp(lw, dim=1, keepdim=True)
    return lw, torch.einsum("nm,nmd->nd", torch.exp(lw), particles)


def pf_update_estimate_backward_reference(lwn, particles, est, g_lw, g_est):
    """Plain torch version of B2's backward (pallas_pf.py:488-507): with
    p = exp(lw'),

      g_s      = g_lw' - p * sum(g_lw') + p * (x . g_est - est . g_est)
      g_x[m,d] = p[m] * g_est[d]

    Returns (g_s (N, M), g_x (N, M, D)); g_s is the gradient of both
    log_weights and log_liks."""
    p = torch.exp(lwn)
    xg = torch.einsum("nmd,nd->nm", particles, g_est)
    eg = torch.sum(est * g_est, dim=1, keepdim=True)
    g_s = g_lw - p * g_lw.sum(dim=1, keepdim=True) + p * (xg - eg)
    return g_s, p[:, :, None] * g_est[:, None, :]


class _Entries:
    """The C entry points of ``csrc/pf_estimate.cu``, bound once, at the
    first launch (building the library if needed), and ``stream(index)``,
    the current stream of a device as a raw handle."""

    fwd = bwd = stream = None

    @classmethod
    def bind(cls):
        cls.stream = torch._C._cuda_getCurrentRawStream
        lib = load_library("pf_estimate")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        # Every pointer and the stream as c_void_p: without argtypes ctypes
        # would pass a Python int as a 32-bit int and cut the pointer.
        for key, symbol, pointers in (("fwd", "pf_update_estimate_fwd_f32", 5),
                                      ("bwd", "pf_update_estimate_bwd_f32", 7)):
            fn = getattr(lib, symbol)
            fn.argtypes, fn.restype = [ptr] * pointers + [i32] * 4 + [ptr], ctypes.c_int
            setattr(cls, key, fn)
        return cls


def _check_cuda_inputs(rows, particles, vectors) -> int:
    """Raises unless `rows` (N, M) and `vectors` (N, D) beside `particles`
    (N, M, D) are float32, contiguous and on one CUDA device, with
    1 <= D <= MAX_D. Returns the device's index. One pass of cheap reads;
    which rule failed is worked out only on failure."""
    index = particles.get_device()
    f32 = torch.float32
    if (particles.is_cuda and particles.dim() == 3 and particles.dtype is f32
            and particles.is_contiguous()):
        n, m, d = particles.shape
        ok = 1 <= d <= MAX_D and n >= 1 and m >= 1
        for group, shape in ((rows, (n, m)), (vectors, (n, d))):
            for x in group:
                ok = (ok and x.get_device() == index and x.dtype is f32
                      and x.is_contiguous() and x.shape == shape)
        if ok:
            return index
    _refuse(rows, particles, vectors)


def _refuse(rows, particles, vectors):
    """Raises the error for inputs ``_check_cuda_inputs`` refused."""
    device = particles.device
    if device.type != "cuda":
        raise ValueError(f"B2 kernels need CUDA tensors, got {device}")
    for x in (*rows, particles, *vectors):
        if x.device != device:
            raise ValueError(f"inputs on several devices: {x.device} and {device}")
        if x.dtype != torch.float32:
            raise ValueError(f"B2 kernels take float32, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError("B2 kernels take contiguous tensors")
    if particles.ndim != 3:
        raise ValueError(f"particles must be (N, M, D), got {tuple(particles.shape)}")
    n, m, d = particles.shape
    for group, shape in ((rows, (n, m)), (vectors, (n, d))):
        for x in group:
            if tuple(x.shape) != shape:
                raise ValueError(f"expected shape {shape}, got {tuple(x.shape)}")
    raise ValueError(f"B2 kernels take N, M >= 1 and 1 <= D <= {MAX_D}, got {(n, m, d)}")


def _launch(entry, name, index, pointers, shape):
    """Calls the C entry `entry` on the current stream of device `index`,
    which the inputs (checked) lie on."""
    if index == torch.cuda.current_device():
        rc = entry(*pointers, *shape, ROWS_PER_BLOCK, _Entries.stream(index))
    else:
        with torch.cuda.device(index):
            rc = entry(*pointers, *shape, ROWS_PER_BLOCK, _Entries.stream(index))
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")


def pf_update_estimate_fwd(log_weights, log_liks, particles):
    """Launch B2f on CUDA tensors. Returns (log_weights' (N, M),
    estimate (N, D))."""
    index = _check_cuda_inputs((log_weights, log_liks), particles, ())
    out_lw = torch.empty_like(log_weights)
    est = particles.new_empty((particles.shape[0], particles.shape[2]))
    _launch(_Entries.fwd or _Entries.bind().fwd, "B2f", index,
            (log_weights.data_ptr(), log_liks.data_ptr(), particles.data_ptr(),
             out_lw.data_ptr(), est.data_ptr()), particles.shape)
    pf_update_estimate_fwd.launches += 1
    return out_lw, est


def pf_update_estimate_bwd(lwn, particles, est, g_lw, g_est):
    """Launch B2b on CUDA tensors. `g_lw` None stands for zeros (an unused
    lw'), which the kernel reads without a tensor. Returns (g_s (N, M),
    g_x (N, M, D))."""
    rows = (lwn,) if g_lw is None else (lwn, g_lw)
    index = _check_cuda_inputs(rows, particles, (est, g_est))
    g_s = torch.empty_like(lwn)
    g_x = torch.empty_like(particles)
    _launch(_Entries.bwd or _Entries.bind().bwd, "B2b", index,
            (lwn.data_ptr(), particles.data_ptr(), est.data_ptr(),
             None if g_lw is None else g_lw.data_ptr(), g_est.data_ptr(),
             g_s.data_ptr(), g_x.data_ptr()), particles.shape)
    pf_update_estimate_bwd.launches += 1
    return g_s, g_x


pf_update_estimate_fwd.launches = 0
pf_update_estimate_bwd.launches = 0


class _UpdateEstimate(torch.autograd.Function):
    """B2f forward, B2b backward. Gradients are not materialised: the last
    step's lw', which nothing reads, reaches the backward as None and the
    kernel as a null pointer (zeros), with no fill and no copy."""

    @staticmethod
    def forward(ctx, log_weights, log_liks, particles):
        ctx.set_materialize_grads(False)
        lwn, est = pf_update_estimate_fwd(log_weights, log_liks, particles)
        ctx.save_for_backward(lwn, particles, est)
        return lwn, est

    @staticmethod
    @once_differentiable
    def backward(ctx, g_lw, g_est):
        if g_lw is None and g_est is None:
            return None, None, None
        lwn, particles, est = ctx.saved_tensors
        g_est = torch.zeros_like(est) if g_est is None else g_est.contiguous()
        g_s, g_x = pf_update_estimate_bwd(lwn, particles, est,
                                          None if g_lw is None else g_lw.contiguous(), g_est)
        return g_s, g_s, g_x


def pf_update_estimate(log_weights, log_liks, particles):
    """Fused train-mode PF update: (log_weights, log_liks (N, M), particles
    (N, M, D)) -> (log_weights' (N, M), estimate (N, D)), differentiable in
    all three inputs."""
    tensors = (log_weights, log_liks, particles)
    if all(x.device.type == "cpu" for x in tensors):
        return pf_update_estimate_reference(*tensors)
    return _UpdateEstimate.apply(*tensors)
