"""B1 (with B4 and B5) and B3 as ``torch.library`` custom ops, so that a
traced program (``torch.export``, ``torch.compile``, ``make_fx``) holds the
hand-written kernels as nodes of its graph. The wrappers in
``pf_kernels.py`` and ``fused_step.py`` reach their kernels through
``ctypes``, which no tracer sees; these ops are the counterpart of the
custom calls in which ``jax.export`` embeds the Pallas kernels.

- ``torch.ops.mmf_torch.pf_tail(log_weights, log_liks, particles, uniforms,
  alpha)`` -> ``(particles', log_weights', estimate)``: the eval step tail,
  ``pf_kernels.pf_update_and_resample`` (B1, B4 or B5 by alpha and M on
  CUDA tensors, the plain version on CPU tensors).
- ``torch.ops.mmf_torch.fused_forward(particles, log_weights, uniforms,
  noise, rows, gate, wd, bd, wm, bm, wdt, wmt)`` -> ``(particles',
  log_weights', estimates)``: the whole eval loop, ``fused_step.fused_forward``
  (B3 on CUDA tensors, its plain version on CPU tensors).

Both return fresh tensors and mutate nothing. The kernels' launch counters
count launches made through the ops, and a CUDA input that a kernel refuses
raises, as with the wrappers. Each has a fake implementation that gives the
output shapes, which is what an exporter traces.

The filters call the wrappers directly and go through the ops only while a
tracer runs (``tracing()``): an op costs host time on every eager call
(``chip_smoke.py``'s ``surface`` phase times both, ``PERF.md``).
"""

from __future__ import annotations

import torch

from ..types import ParticleBelief
from . import fused_step, pf_kernels

NAMESPACE = "mmf_torch"
_PROXY = torch._C._TorchDispatchModeKey.PROXY


def tracing() -> bool:
    """True while ``torch.export``, ``torch.compile`` or ``make_fx`` traces
    the caller: a kernel launched through ``ctypes`` would then be missing
    from the traced program, so the filters call the ops. (A proxy mode on
    the dispatch stack is ``make_fx``; read from the stack directly, as
    ``get_proxy_mode`` does, at a fifth of its host time.)"""
    return (torch.compiler.is_exporting() or torch.compiler.is_compiling()
            or torch._C._get_dispatch_mode(_PROXY) is not None)


@torch.library.custom_op(f"{NAMESPACE}::pf_tail", mutates_args=())
def pf_tail(log_weights: torch.Tensor, log_liks: torch.Tensor, particles: torch.Tensor,
            uniforms: torch.Tensor, alpha: float) -> tuple[torch.Tensor, torch.Tensor,
                                                           torch.Tensor]:
    return pf_kernels.pf_update_and_resample(log_weights, log_liks, particles, uniforms,
                                             alpha=alpha)


@pf_tail.register_fake
def _pf_tail_fake(log_weights, log_liks, particles, uniforms, alpha):
    n, _, d = particles.shape
    return (torch.empty_like(particles), torch.empty_like(log_weights),
            particles.new_empty((n, d)))


_FUSED_FIELDS = ("noise", "rows", "gate", "wd", "bd", "wm", "bm", "wdt", "wmt")


@torch.library.custom_op(f"{NAMESPACE}::fused_forward", mutates_args=())
def fused_forward(particles: torch.Tensor, log_weights: torch.Tensor,
                  uniforms: torch.Tensor, noise: torch.Tensor, rows: torch.Tensor,
                  gate: torch.Tensor, wd: torch.Tensor, bd: torch.Tensor, wm: torch.Tensor,
                  bm: torch.Tensor, wdt: torch.Tensor, wmt: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    ops = fused_step.FusedOperands(noise, rows, gate, wd, bd, wm, bm, wdt, wmt)
    belief, estimates = fused_step.fused_forward(
        ops, ParticleBelief(particles, log_weights), uniforms)
    return belief.particles, belief.log_weights, estimates


@fused_forward.register_fake
def _fused_forward_fake(particles, log_weights, uniforms, *operands):
    n, _, d = particles.shape
    return (torch.empty_like(particles), torch.empty_like(log_weights),
            particles.new_empty((uniforms.shape[0], n, d)))


def fused_forward_op(ops, belief, uniforms):
    """``fused_step.fused_forward`` through the op: (final belief,
    estimates (T, N, D))."""
    particles, log_weights, estimates = fused_forward(
        belief.particles, belief.log_weights, uniforms,
        *(getattr(ops, name) for name in _FUSED_FIELDS))
    return ParticleBelief(particles, log_weights), estimates
