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
import functools

import torch
from torch.autograd.function import once_differentiable

from ._build import load_library

MAX_D = 8


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


@functools.cache
def _kernels():
    lib = load_library("pf_estimate")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    # Every pointer and the stream as c_void_p: without argtypes ctypes would
    # pass a Python int as a 32-bit int and cut the pointer.
    fwd, bwd = lib.pf_update_estimate_fwd_f32, lib.pf_update_estimate_bwd_f32
    fwd.argtypes = [ptr] * 5 + [i32, i32, i32, ptr]
    bwd.argtypes = [ptr] * 7 + [i32, i32, i32, ptr]
    fwd.restype = bwd.restype = ctypes.c_int
    return fwd, bwd


def _check_cuda_inputs(rows, particles, vectors):
    """`rows` (N, M) and `vectors` (N, D) beside `particles` (N, M, D):
    fp32, contiguous, all on one CUDA device, 1 <= D <= MAX_D."""
    device = particles.device
    if device.type != "cuda":
        raise ValueError(f"B2 kernels need CUDA tensors, got {device}")
    if particles.ndim != 3:
        raise ValueError(f"particles must be (N, M, D), got {tuple(particles.shape)}")
    n, m, d = particles.shape
    if not 1 <= d <= MAX_D or n < 1 or m < 1:
        raise ValueError(f"B2 kernels take N, M >= 1 and 1 <= D <= {MAX_D}, "
                         f"got {(n, m, d)}")
    for shape, group in (((n, m), rows), ((n, m, d), (particles,)), ((n, d), vectors)):
        for x in group:
            if x.device != device:
                raise ValueError(f"inputs on several devices: {x.device} and {device}")
            if x.dtype != torch.float32:
                raise ValueError(f"B2 kernels take float32, got {x.dtype}")
            if not x.is_contiguous():
                raise ValueError("B2 kernels take contiguous tensors")
            if tuple(x.shape) != shape:
                raise ValueError(f"expected shape {shape}, got {tuple(x.shape)}")
    return n, m, d


def pf_update_estimate_fwd(log_weights, log_liks, particles):
    """Launch B2f on CUDA tensors. Returns (log_weights' (N, M),
    estimate (N, D))."""
    n, m, d = _check_cuda_inputs((log_weights, log_liks), particles, ())
    out_lw = torch.empty_like(log_weights)
    est = torch.empty((n, d), dtype=particles.dtype, device=particles.device)
    with torch.cuda.device(particles.device):
        rc = _kernels()[0](
            log_weights.data_ptr(), log_liks.data_ptr(), particles.data_ptr(),
            out_lw.data_ptr(), est.data_ptr(), n, m, d,
            torch.cuda.current_stream().cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"B2f kernel launch failed: cudaError {rc}")
    pf_update_estimate_fwd.launches += 1
    return out_lw, est


def pf_update_estimate_bwd(lwn, particles, est, g_lw, g_est):
    """Launch B2b on CUDA tensors. Returns (g_s (N, M), g_x (N, M, D))."""
    n, m, d = _check_cuda_inputs((lwn, g_lw), particles, (est, g_est))
    g_s = torch.empty_like(lwn)
    g_x = torch.empty_like(particles)
    with torch.cuda.device(particles.device):
        rc = _kernels()[1](
            lwn.data_ptr(), particles.data_ptr(), est.data_ptr(), g_lw.data_ptr(),
            g_est.data_ptr(), g_s.data_ptr(), g_x.data_ptr(), n, m, d,
            torch.cuda.current_stream().cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"B2b kernel launch failed: cudaError {rc}")
    pf_update_estimate_bwd.launches += 1
    return g_s, g_x


pf_update_estimate_fwd.launches = 0
pf_update_estimate_bwd.launches = 0


class _UpdateEstimate(torch.autograd.Function):
    """B2f forward, B2b backward. Unused outputs (the last step's lw')
    reach the backward as zeros (materialised grads, the default)."""

    @staticmethod
    def forward(ctx, log_weights, log_liks, particles):
        lwn, est = pf_update_estimate_fwd(log_weights, log_liks, particles)
        ctx.save_for_backward(lwn, particles, est)
        return lwn, est

    @staticmethod
    @once_differentiable
    def backward(ctx, g_lw, g_est):
        lwn, particles, est = ctx.saved_tensors
        g_s, g_x = pf_update_estimate_bwd(lwn, particles, est,
                                          g_lw.contiguous(), g_est.contiguous())
        return g_s, g_s, g_x


def pf_update_estimate(log_weights, log_liks, particles):
    """Fused train-mode PF update: (log_weights, log_liks (N, M), particles
    (N, M, D)) -> (log_weights' (N, M), estimate (N, D)), differentiable in
    all three inputs."""
    tensors = (log_weights, log_liks, particles)
    if all(x.device.type == "cpu" for x in tensors):
        return pf_update_estimate_reference(*tensors)
    return _UpdateEstimate.apply(*tensors)
