"""Plain fp32 reference of the particle filter's eval loop, its end-to-end
training loss, and Adam, over ``nets.py``.

Eval, per step: propagate every particle through the dynamics, add the
process noise (its diagonal standard deviations times the step's normal
draws), weigh by the fused log-likelihoods, take the weighted mean as the
step's estimate, then resample multinomially by inverse CDF from the
step's uniforms (the first slot whose CDF reaches the uniform; the CDF is
not divided by its last entry) and reset the weights to uniform. A uniform
within rounding of a CDF entry may draw the neighbouring slot on another
side that sums in another order, and from there the two sides' particles
part: with a `margin`, each such uniform is drawn again until none lies
that close, and the loop returns the uniforms it drew with.

Training (BPTT, no resampling): beliefs at the true first state plus
``sqrt(initial_cov_scale)`` times the normal draws, then L-1 steps of
propagate, weigh and log-normalise, the estimate the weighted mean; the
loss is the mean squared error of the estimates against the true states.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from . import nets


def _frames(obs: Dict[str, torch.Tensor], controls):
    """(T, N, ...) inputs -> (T*N, ...)."""
    t, n = controls.shape[:2]
    flat = {k: v.reshape((t * n,) + tuple(v.shape[2:])) for k, v in obs.items()}
    return flat, controls.reshape(t * n, -1)


def eval_loop(w, cfg, obs, controls, mean, covariance, eps0, eps_seq, uniforms,
              margin: float = 0.0, redraw=None):
    """One request: N trajectories of T steps from the belief N(mean, cov)
    drawn with `eps0` (N, M, D). obs (T, N, ...), controls (T, N, C),
    eps_seq (T, N*M, D), uniforms (T, N, M). Returns the estimates
    (T, N, D) and the uniforms drawn with (T, N, M): those given, save that
    with `margin` > 0 each uniform closer than `margin` to an entry of its
    step's CDF is replaced by a fresh one from the generator `redraw`."""
    n, m, d = eps0.shape
    t = controls.shape[0]
    q = torch.tensor(cfg["process_noise_std"], dtype=eps0.dtype, device=eps0.device)
    chol = torch.linalg.cholesky(covariance)
    x = mean[:, None, :] + torch.einsum("nij,nmj->nmi", chol, eps0)
    lw = torch.full((n, m), -math.log(m), dtype=x.dtype, device=x.device)
    flat_obs, flat_ctrl = _frames(obs, controls)
    dyn_rows, mm_rows, gate = nets.frame_terms(w, cfg, flat_obs, flat_ctrl)
    dyn_rows = dyn_rows.reshape(t, n, -1)
    mm_rows = mm_rows.reshape(mm_rows.shape[0], t, n, -1)
    gate = gate.reshape(t, n, -1)
    estimates, drawn = [], []
    for i in range(t):
        flat = x.reshape(n * m, d)
        new = nets.propagate(w, cfg, flat, dyn_rows[i].repeat_interleave(m, dim=0))
        new = (new + q * eps_seq[i]).reshape(n, m, d)
        ll = nets.log_likelihoods(
            w, cfg, new.reshape(n * m, d), mm_rows[:, i].repeat_interleave(m, dim=1),
            gate[i].repeat_interleave(m, dim=0)).reshape(n, m)
        lw = lw + ll
        p = torch.softmax(lw, dim=1)
        estimates.append(torch.einsum("nm,nmd->nd", p, new))
        cdf = torch.cumsum(p, dim=1)
        u = uniforms[i].contiguous()
        idx = _draw(cdf, u)
        for _ in range(64 if margin > 0 else 0):
            near = _distance_to_cdf(cdf, u, idx) < margin
            if not bool(near.any()):
                break
            u = torch.where(near, torch.rand(u.shape, generator=redraw, device=u.device,
                                             dtype=u.dtype), u)
            idx = _draw(cdf, u)
        else:
            if margin > 0:
                raise RuntimeError("uniforms still on a CDF entry after 64 draws")
        drawn.append(u)
        x = new.gather(1, idx[:, :, None].expand(n, m, d))
        lw = torch.full((n, m), -math.log(m), dtype=x.dtype, device=x.device)
    return torch.stack(estimates), torch.stack(drawn)


def _draw(cdf, u):
    """The first slot whose CDF entry reaches the uniform."""
    return torch.searchsorted(cdf, u).clamp_(max=cdf.shape[-1] - 1)


def _distance_to_cdf(cdf, u, idx):
    """Each uniform's distance to the nearer of the two CDF entries around
    it (the one it draws and the one before)."""
    lo = (idx - 1).clamp(min=0)
    return torch.minimum((cdf.gather(1, idx) - u).abs(), (cdf.gather(1, lo) - u).abs())


def e2e_loss(w, cfg, states, controls, obs, eps0, eps_seq, initial_cov_scale: float):
    """The end-to-end loss of one batch: states (B, L, D), controls
    (B, L, C), obs (B, L, ...), eps0 (B, M, D), eps_seq (L-1, B*M, D)."""
    b, seq_len, d = states.shape
    m = eps0.shape[1]
    q = torch.tensor(cfg["process_noise_std"], dtype=eps0.dtype, device=eps0.device)
    x = states[:, 0, None, :] + math.sqrt(initial_cov_scale) * eps0
    lw = torch.full((b, m), -math.log(m), dtype=x.dtype, device=x.device)
    rest_obs = {k: v[:, 1:].transpose(0, 1) for k, v in obs.items()}
    flat_obs, flat_ctrl = _frames(rest_obs, controls[:, 1:].transpose(0, 1))
    t = seq_len - 1
    dyn_rows, mm_rows, gate = nets.frame_terms(w, cfg, flat_obs, flat_ctrl)
    dyn_rows = dyn_rows.reshape(t, b, -1)
    mm_rows = mm_rows.reshape(mm_rows.shape[0], t, b, -1)
    gate = gate.reshape(t, b, -1)
    estimates = []
    for i in range(t):
        new = nets.propagate(w, cfg, x.reshape(b * m, d), dyn_rows[i].repeat_interleave(m, dim=0))
        x = (new + q * eps_seq[i]).reshape(b, m, d)
        ll = nets.log_likelihoods(
            w, cfg, x.reshape(b * m, d), mm_rows[:, i].repeat_interleave(m, dim=1),
            gate[i].repeat_interleave(m, dim=0)).reshape(b, m)
        lw = lw + ll
        lw = lw - torch.logsumexp(lw, dim=1, keepdim=True)
        estimates.append(torch.einsum("bm,bmd->bd", torch.exp(lw), x))
    return torch.mean((torch.stack(estimates) - states[:, 1:].transpose(0, 1)) ** 2)


class Adam:
    """Adam as Kingma and Ba state it: moments with betas (0.9, 0.999),
    bias-corrected, eps added outside the square root."""

    def __init__(self, params: Dict[str, torch.Tensor], lr: float,
                 betas=(0.9, 0.999), eps: float = 1e-8, moments=None, t: int = 0):
        """`moments` (first, second), dicts of tensors, and the step count
        `t` continue an optimizer that has taken `t` steps; else zeros."""
        self.lr, self.betas, self.eps, self.t = lr, betas, eps, t
        if moments is None:
            moments = ({k: torch.zeros_like(v) for k, v in params.items()},
                       {k: torch.zeros_like(v) for k, v in params.items()})
        self.m, self.v = ({k: v.clone() for k, v in part.items()} for part in moments)

    def step(self, params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor]):
        """The parameters after one step (new tensors)."""
        b1, b2 = self.betas
        self.t += 1
        out = {}
        for k, p in params.items():
            g = grads[k]
            self.m[k] = b1 * self.m[k] + (1 - b1) * g
            self.v[k] = b2 * self.v[k] + (1 - b2) * g * g
            m_hat = self.m[k] / (1 - b1 ** self.t)
            v_hat = self.v[k] / (1 - b2 ** self.t)
            out[k] = p - self.lr * m_hat / (torch.sqrt(v_hat) + self.eps)
        return out
