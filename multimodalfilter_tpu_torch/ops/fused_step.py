"""The whole eval ``forward_loop`` as one kernel, B3 (port of
``multimodalfilter_tpu/ops/pallas_fused_step.py``): packing, the hoisted
host-side products, the plain version and the kernel's wrapper.

The small-N serving route (``ParticleFilterDef.fused_step``, set by
``utils.precision.with_fused_step`` or ``MMF_TPU_FUSED_STEP=1``). The per-step
path dispatches some 90 small kernels per filter step; here one launch runs
every step of every trajectory, the belief carried on chip.

``pack_operands`` turns the port's own modules into the kernel's operands:
each trunk's 64x64 layers stacked and zero-padded (``nn.Linear.weight`` is
already (out, in), the feature-major orientation), the dense_in layers split
into their state half (in the kernel) and their carry-independent half,
which runs here over all T*N rows as one product (``rows``), the noise
scaled by the process noise's diagonal, and the gate's log-weights of the
enabled modalities. A configuration the kernel does not cover raises
``Unsupported``; ``try_fused_forward`` turns that into a fallback to the
per-step path, with the reason in ``packing_report()`` and one warning.

``fused_forward`` runs the plain version ``fused_forward_reference`` (the
same recursion in torch ops, the tail through
``pf_update_and_resample_reference``) on CPU tensors, and on CUDA tensors
launches ``csrc/pf_fused_step.cu`` or raises. The kernel runs each
trajectory on a thread-block cluster of ``cluster_size(M)`` blocks, one per
64-particle tile; ``launch_plan`` reports what the C entry launches, and a
cluster the card refuses raises. ``fused_forward_kernel.launches`` counts
the kernel's launches.

Supported, as in JAX: eval, multinomial resampling (alpha >= 1), units=64
``DynamicsNet`` and ``LogLikelihoodNet`` trunks (under a
``CrossmodalPFMeasurementDef``, gated or not, or alone), constant diagonal
process noise, M <= 512; and the kernel's own limits K <= 4, D <= 8.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import warnings
from typing import NamedTuple, Optional

import torch

from ..types import ParticleBelief
from ..utils.debug import SPAN_FUSED_LAUNCH, SPAN_FUSED_PACK, span
from ._build import load_library
from .pf_kernels import pf_update_and_resample_reference

UNITS = 64
TILE = 64  # particles per block of a trajectory's cluster
FUSED_M_MAX = 512  # 8 tiles: the portable cluster size
MAX_K = 4
MAX_D = 8
DYN_LAYERS = 11
MEAS_LAYERS = 9


class Unsupported(Exception):
    """The configuration is outside what B3 covers."""


def _require(cond: bool, why: str) -> None:
    if not cond:
        raise Unsupported(why)


# ---------------------------------------------------------------------------
# Packing: the port's nn.Modules -> stacked, padded feature-major operands
# ---------------------------------------------------------------------------


def _wt(weight, out_rows: int = UNITS, in_cols: int = UNITS):
    """An (out, in) weight zero-padded to (out_rows, in_cols)."""
    o, i = weight.shape
    return torch.nn.functional.pad(weight, (0, in_cols - i, 0, out_rows - o))


def _bias(bias, rows: int = UNITS):
    return torch.nn.functional.pad(bias, (0, rows - bias.shape[0]))


def _mlp_layers(encoder):
    """MLPEncoder -> its 3 (weight, bias) pairs: dense, resblock.block1/2."""
    return [(encoder.dense.weight, encoder.dense.bias),
            (encoder.resblock.block1.weight, encoder.resblock.block1.bias),
            (encoder.resblock.block2.weight, encoder.resblock.block2.bias)]


def _stack(layers):
    return (torch.stack([_wt(w) for w, _ in layers]),
            torch.stack([_bias(b) for _, b in layers]))


def _pack_dynamics(net, d: int):
    """DynamicsNet trunk -> (wd (11, 64, 64), bd (11, 64), w_in_ctrl
    (64, 64), b_in (64,)). The dense_in layer is split: its control half is
    hoisted, its state half (bias 0: the bias goes with the hoisted row)
    runs in the kernel. Concat order (control, state)."""
    for key in ("state_layers", "shared_dense_in", "shared_resblock0",
                "shared_resblock1", "shared_resblock2", "shared_dense_out"):
        _require(hasattr(net, key), f"dynamics missing {key}")
    w_in = net.shared_dense_in.weight
    _require(tuple(w_in.shape) == (UNITS, 2 * UNITS),
             f"dynamics dense_in {tuple(w_in.shape)} != (64, 128) (units != 64?)")
    layers = _mlp_layers(net.state_layers)
    layers.append((w_in[:, UNITS:], torch.zeros_like(net.shared_dense_in.bias)))
    for r in range(3):
        block = getattr(net, f"shared_resblock{r}")
        layers += [(block.block1.weight, block.block1.bias),
                   (block.block2.weight, block.block2.bias)]
    out = net.shared_dense_out
    _require(tuple(out.weight.shape) == (d + 1, UNITS),
             "dynamics dense_out is not (D+1, units)")
    layers.append((out.weight, out.bias))
    wd, bd = _stack(layers)
    return wd, bd, w_in[:, :UNITS], net.shared_dense_in.bias


def _pack_measurement(net, d: int):
    """LogLikelihoodNet trunk -> (wm (9, 64, 64), bm (9, 64), w_in_obs
    (64, F), b_in (64,), F). dense_in split as in _pack_dynamics; concat
    order (obs features, state)."""
    for key in ("state_layers", "shared_dense_in", "shared_resblock0",
                "shared_resblock1", "shared_dense_out"):
        _require(hasattr(net, key), f"measurement missing {key}")
    w_in = net.shared_dense_in.weight
    _require(w_in.ndim == 2 and w_in.shape[0] == UNITS and w_in.shape[1] > UNITS,
             f"measurement dense_in {tuple(w_in.shape)}")
    f = w_in.shape[1] - UNITS
    layers = _mlp_layers(net.state_layers)
    layers.append((w_in[:, f:], torch.zeros_like(net.shared_dense_in.bias)))
    for r in range(2):
        block = getattr(net, f"shared_resblock{r}")
        layers += [(block.block1.weight, block.block1.bias),
                   (block.block2.weight, block.block2.bias)]
    out = net.shared_dense_out
    _require(tuple(out.weight.shape) == (1, UNITS), "measurement dense_out is not (1, units)")
    layers.append((out.weight, out.bias))
    wm, bm = _stack(layers)
    return wm, bm, w_in[:, :f], net.shared_dense_in.bias, f


def _normalize_modalities(defn, features_seq, enabled):
    """-> (measurement nets, features (T, N, F) each, gate (T, N, K) or
    None), for the enabled modalities."""
    mm = defn.measurement_model
    if hasattr(mm, "measurement_models"):  # CrossmodalPFMeasurementDef
        en = enabled if enabled is not None else (True,) * len(mm.measurement_models)
        nets, feats = [], []
        for i, sub in enumerate(mm.measurement_models):
            if not en[i]:
                continue
            _require(hasattr(sub, "net"), "submodel without net")
            nets.append(sub.net)
            feats.append(features_seq[str(i)])
        _require(len(nets) >= 1, "no enabled modalities")
        gate = None
        if mm.crossmodal_weight_model is not None:
            gate = features_seq["_log_weights"][..., [i for i, e in enumerate(en) if e]]
        return nets, feats, gate
    _require(hasattr(mm, "net") and not isinstance(features_seq, dict),
             "unrecognized feature layout")
    return [mm.net], [features_seq], None


@dataclasses.dataclass
class FusedOperands:
    """Everything B3 reads besides the belief and the uniforms. T-major:
    noise (T, N, M, D) already scaled by the noise diagonal; rows
    (T, N, 1+K, 64), the hoisted dense_in halves plus biases (dynamics
    first, then each modality); gate (T, N, K). Weights: wd (11, 64, 64),
    bd (11, 64), wm (K, 9, 64, 64), bm (K, 9, 64), each layer (out, in);
    wdt and wmt the same layers as (in, out), the kernel's layout."""

    noise: torch.Tensor
    rows: torch.Tensor
    gate: torch.Tensor
    wd: torch.Tensor
    bd: torch.Tensor
    wm: torch.Tensor
    bm: torch.Tensor
    wdt: torch.Tensor
    wmt: torch.Tensor

    def step(self, t: int) -> "FusedOperands":
        """The operands of step t alone (T = 1)."""
        sl = slice(t, t + 1)
        return dataclasses.replace(self, noise=self.noise[sl], rows=self.rows[sl],
                                   gate=self.gate[sl])


def pack_operands(defn, features_seq, ctrl_feat_seq, eps_seq, enabled,
                  num_particles: int) -> FusedOperands:
    """The kernel's operands for ``defn``'s eval loop, from
    ``forward_loop``'s hoisted inputs: features_seq (per-modality (T, N, F)
    and '_log_weights', or one (T, N, F)), ctrl_feat_seq (T, N, 64) and
    eps_seq (T, N*M, D). Raises ``Unsupported`` with the reason."""
    m = num_particles
    _require(m <= FUSED_M_MAX, f"M={m} > {FUSED_M_MAX}")
    _require(defn.soft_resample_alpha >= 1.0, "soft resampling")
    _require(ctrl_feat_seq is not None, "dynamics net without a control split")
    dyn_net = defn.dynamics_model.net
    # A net built from a noise diagonal (the JAX packing's test, with no
    # read of the tensor's values, which a tracer could not branch on).
    _require(hasattr(dyn_net, "q_scale_tril_diag"), "dynamics noise is not constant-diagonal")
    q = dyn_net.q_scale_tril
    _require(ctrl_feat_seq.shape[-1] == UNITS, "control features != 64")
    t, n = ctrl_feat_seq.shape[:2]
    d = defn.state_dim
    _require(d <= MAX_D, f"state dim {d} > {MAX_D}")

    nets, feats, gate = _normalize_modalities(defn, features_seq, enabled)
    k = len(nets)
    _require(k <= MAX_K, f"{k} modalities > {MAX_K}")
    wd, bd, w_in_ctrl, b_in_dyn = _pack_dynamics(dyn_net, d)
    packed = [_pack_measurement(net, d) for net in nets]
    for (_, _, _, _, f), feat in zip(packed, feats):
        _require(feat.ndim == 3 and feat.shape[-1] == f,
                 f"feature width {tuple(feat.shape)} != dense_in obs columns {f}")
    wm = torch.stack([p[0] for p in packed])
    bm = torch.stack([p[1] for p in packed])

    # Carry-independent dense_in halves over all T*N rows at once.
    rows = torch.stack(
        [ctrl_feat_seq @ w_in_ctrl.T + b_in_dyn]
        + [feat @ p[2].T + p[3] for p, feat in zip(packed, feats)],
        dim=2,
    ).contiguous()
    if gate is None:
        gate = torch.zeros((t, n, k), dtype=rows.dtype, device=rows.device)
    noise = (eps_seq.reshape(t, n, m, d) * torch.diagonal(q).to(eps_seq.dtype)).contiguous()
    return FusedOperands(
        noise=noise, rows=rows, gate=gate.contiguous(), wd=wd, bd=bd, wm=wm, bm=bm,
        wdt=wd.transpose(1, 2).contiguous(), wmt=wm.transpose(2, 3).contiguous(),
    )


# ---------------------------------------------------------------------------
# The plain version and the kernel
# ---------------------------------------------------------------------------


def _dense(x, w, b):
    return x @ w.T + b


def _resblock(x, w, b, layer):
    h = torch.relu(_dense(x, w[layer], b[layer]))
    return x + torch.relu(_dense(h, w[layer + 1], b[layer + 1]))


def fused_forward_reference(ops: FusedOperands, belief, uniforms, record=None):
    """Plain torch version of B3: the kernel's recursion, with its split
    dense_in layers, the raw logsumexp over gated modalities and the tail
    through ``pf_update_and_resample_reference``. uniforms (T, N, M).
    Returns (final belief, estimates (T, N, D)). If ``record`` is a list,
    each step appends its tail's inputs (log_weights, log_liks, uniforms,
    propagated particles)."""
    particles, log_weights = belief
    n, m, d = particles.shape
    wd, bd, wm, bm = ops.wd, ops.bd, ops.wm, ops.bm
    estimates = []
    for t in range(ops.rows.shape[0]):
        x = particles.reshape(n * m, d)
        rows = ops.rows[t].repeat_interleave(m, dim=0)  # (N*M, 1+K, 64)
        h = torch.relu(x @ wd[0, :, :d].T + bd[0])
        h = _resblock(h, wd, bd, 1)
        z = h @ wd[3].T + rows[:, 0]  # dense_in: no activation (ref quirk)
        for layer in (4, 6, 8):
            z = _resblock(z, wd, bd, layer)
        o = z @ wd[10, : d + 1].T + bd[10, : d + 1]
        new = x + o[:, :d] * torch.sigmoid(o[:, d:]) + ops.noise[t].reshape(n * m, d)
        lls = []
        for k in range(wm.shape[0]):
            h = torch.relu(new @ wm[k, 0, :, :d].T + bm[k, 0])
            h = _resblock(h, wm[k], bm[k], 1)
            z = torch.relu(h @ wm[k, 3].T + rows[:, 1 + k])
            for layer in (4, 6):
                z = _resblock(z, wm[k], bm[k], layer)
            ll = z @ wm[k, 8, 0] + bm[k, 8, 0]
            lls.append(ll.reshape(n, m) + ops.gate[t, :, k:k + 1])
        ll = lls[0] if len(lls) == 1 else torch.logsumexp(torch.stack(lls, dim=-1), dim=-1)
        new = new.reshape(n, m, d)
        if record is not None:
            record.append((log_weights, ll, uniforms[t], new))
        particles, log_weights, est = pf_update_and_resample_reference(
            log_weights, ll, new, uniforms[t].contiguous()
        )
        estimates.append(est)
    return ParticleBelief(particles, log_weights), torch.stack(estimates)


def cluster_size(m: int) -> int:
    """Blocks in each trajectory's cluster: one per 64-particle tile."""
    return -(-m // TILE)


class LaunchPlan(NamedTuple):
    """What B3's C entry launches for N trajectories of M particles:
    ``cluster`` blocks a trajectory, ``blocks`` in all, and how many such
    clusters the card holds at once (``cudaOccupancyMaxActiveClusters``; a
    launch over more trajectories runs the rest in a later wave)."""

    cluster: int
    blocks: int
    max_active_clusters: int


@functools.cache
def _library():
    lib = load_library("pf_fused_step")
    ptr, i32, out = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_int)
    lib.pf_fused_forward_f32.argtypes = [ptr] * 14 + [i32] * 5 + [ptr]
    lib.pf_fused_forward_plan.argtypes = [i32, i32, out, out, out]
    for fn in (lib.pf_fused_forward_f32, lib.pf_fused_forward_plan):
        fn.restype = ctypes.c_int
    return lib


def _kernel():
    return _library().pf_fused_forward_f32


def launch_plan(n: int, m: int) -> LaunchPlan:
    """B3's launch for N trajectories of M, as the C entry sets it up.
    Needs the card."""
    vals = [ctypes.c_int(0) for _ in range(3)]
    rc = _library().pf_fused_forward_plan(n, m, *map(ctypes.byref, vals))
    if rc != 0:
        raise RuntimeError(f"B3 launch plan failed: cudaError {rc}")
    return LaunchPlan(*(v.value for v in vals))


def _check_cuda_inputs(ops: FusedOperands, particles, log_weights, uniforms):
    device = particles.device
    if device.type != "cuda":
        raise ValueError(f"B3 kernel needs CUDA tensors, got {device}")
    named = {"particles": particles, "log_weights": log_weights, "uniforms": uniforms,
             **{f.name: getattr(ops, f.name) for f in dataclasses.fields(ops)}}
    for name, x in named.items():
        if x.device != device:
            raise ValueError(f"{name} on {x.device}, particles on {device}")
        if x.dtype != torch.float32:
            raise ValueError(f"B3 kernel takes float32, got {x.dtype} for {name}")
        if not x.is_contiguous():
            raise ValueError(f"B3 kernel takes contiguous tensors ({name})")
    for name in ("wdt", "wmt"):  # copied 16 bytes at a time
        if named[name].data_ptr() % 16:
            raise ValueError(f"B3 kernel takes 16-byte aligned {name}")
    if particles.ndim != 3 or uniforms.ndim != 3:
        raise ValueError("particles must be (N, M, D) and uniforms (T, N, M)")
    n, m, d = particles.shape
    t = uniforms.shape[0]
    k = ops.wm.shape[0]
    expected = {"log_weights": (n, m), "uniforms": (t, n, m), "noise": (t, n, m, d),
                "rows": (t, n, 1 + k, UNITS), "gate": (t, n, k),
                "wdt": (DYN_LAYERS, UNITS, UNITS), "bd": (DYN_LAYERS, UNITS),
                "wmt": (k, MEAS_LAYERS, UNITS, UNITS), "bm": (k, MEAS_LAYERS, UNITS)}
    for name, shape in expected.items():
        if tuple(named[name].shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(named[name].shape)}")
    if not (1 <= m <= FUSED_M_MAX and 1 <= d <= MAX_D and 1 <= k <= MAX_K
            and n >= 1 and t >= 1):
        raise ValueError(f"B3 kernel takes M <= {FUSED_M_MAX}, D <= {MAX_D}, "
                         f"K <= {MAX_K}, got M={m}, D={d}, K={k}")


def fused_forward_kernel(ops: FusedOperands, belief, uniforms, *, log_liks_out=None):
    """B3 on CUDA tensors: every step of the loop in one launch. Returns
    (final belief, estimates (T, N, D)). A (T, N, M) ``log_liks_out``
    receives each step's fused log-likelihoods (for checks)."""
    particles, log_weights = belief
    _check_cuda_inputs(ops, particles, log_weights, uniforms)
    n, m, d = particles.shape
    t = uniforms.shape[0]
    if log_liks_out is not None and not (
            log_liks_out.device == particles.device and log_liks_out.dtype == torch.float32
            and log_liks_out.is_contiguous() and tuple(log_liks_out.shape) == (t, n, m)):
        raise ValueError(f"log_liks_out must be contiguous float32 {(t, n, m)} on "
                         f"{particles.device}")
    est = torch.empty((t, n, d), dtype=torch.float32, device=particles.device)
    out_p = torch.empty_like(particles)
    out_lw = torch.empty_like(log_weights)
    with torch.cuda.device(particles.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _kernel()(
            particles.data_ptr(), log_weights.data_ptr(), ops.noise.data_ptr(),
            uniforms.data_ptr(), ops.rows.data_ptr(), ops.gate.data_ptr(),
            ops.wdt.data_ptr(), ops.bd.data_ptr(), ops.wmt.data_ptr(), ops.bm.data_ptr(),
            est.data_ptr(), out_p.data_ptr(), out_lw.data_ptr(),
            None if log_liks_out is None else log_liks_out.data_ptr(),
            n, t, m, d, ops.wm.shape[0], stream,
        )
    if rc != 0:
        raise RuntimeError(f"B3 kernel launch failed: cudaError {rc}")
    fused_forward_kernel.launches += 1
    return ParticleBelief(out_p, out_lw), est


fused_forward_kernel.launches = 0


def fused_forward(ops: FusedOperands, belief, uniforms):
    """The plain version on CPU tensors, the kernel on CUDA tensors."""
    if belief.particles.device.type == "cpu":
        return fused_forward_reference(ops, belief, uniforms)
    contiguous = ParticleBelief(*(x.contiguous() for x in belief))
    return fused_forward_kernel(ops, contiguous, uniforms.contiguous())


_last_fallback_reason: Optional[str] = None


def packing_report() -> Optional[str]:
    """Why the last ``try_fused_forward`` call fell back (None: it ran)."""
    return _last_fallback_reason


def try_fused_forward(defn, belief, features_seq, ctrl_feat_seq, eps_seq, uni_seq,
                      enabled, run=None):
    """Run ``defn``'s eval forward_loop as B3 (or its plain version on the
    CPU), or return None when the configuration does not qualify; then
    ``packing_report()`` says why and one warning repeats it. Inputs are
    forward_loop's hoisted arrays; ``run`` (default ``fused_forward``) runs
    the packed loop: ``custom_ops.fused_forward_op`` under a tracer."""
    global _last_fallback_reason
    try:
        with span(SPAN_FUSED_PACK):
            ops = pack_operands(defn, features_seq, ctrl_feat_seq, eps_seq, enabled,
                                belief.particles.shape[1])
    except Unsupported as exc:
        _last_fallback_reason = str(exc)
        warnings.warn(f"fused_step: {exc}; running the per-step path", stacklevel=3)
        return None
    _last_fallback_reason = None
    with span(SPAN_FUSED_LAUNCH):
        return (run or fused_forward)(ops, belief, uni_seq)
