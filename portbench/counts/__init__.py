"""The work a configuration's shapes need, and each kernel's least time on
the chip: the yardstick of every ``*_roofline`` and ``mfu.*`` metric.

Counts follow the shapes, never an implementation: a later change that
fuses or removes a kernel leaves what these functions return unchanged.
Operations are 2 per multiply-add of a convolution or dense layer (as
``torch.utils.flop_counter`` counts them); ``*_flops`` adds the
elementwise terms named in each docstring. Bytes count each input read
once and each output written once. The bound arithmetic of B1, B2 and B3
is ``chip_smoke.py``'s (``tail_bound_ms``, ``b2_bound_ms``,
``b3_bound_ms``), copied here.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense rates at the 700 W power limit.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

IMAGE_CONVS = ((1, 32, 5), (32, 32, 3), (32, 32, 3), (32, 16, 3), (16, 8, 3))
OBS_DIM_KEYS = {"pos": "pos_dim", "sensors": "sensors_dim"}


def _dense(n_in: int, n_out: int) -> int:
    return 2 * n_in * n_out


def _mlp(n_in: int, u: int) -> int:
    return _dense(n_in, u) + 2 * _dense(u, u)


def image_encoder_macs2(cfg) -> int:
    """One frame through the image encoder: the five convolutions
    ('same' padding, so every output pixel), the dense and its resblock."""
    side, u = cfg["image_size"], cfg["units"]
    convs = sum(2 * c_in * c_out * k * k * side * side for c_in, c_out, k in IMAGE_CONVS)
    return convs + _dense(IMAGE_CONVS[-1][1] * side * side, u) + 2 * _dense(u, u)


def _encoders(cfg, modalities) -> int:
    u = cfg["units"]
    return sum(image_encoder_macs2(cfg) if mod == "image" else _mlp(cfg[OBS_DIM_KEYS[mod]], u)
               for mod in modalities)


def frame_macs2(cfg) -> int:
    """Everything of one frame that does not depend on a particle: the
    control encoder and the dynamics' control half of dense_in, each
    modality model's encoders and observation half of dense_in, the gate's
    encoders (all modalities) and head."""
    u = cfg["units"]
    mods = cfg["measurement_modalities"]
    total = _mlp(cfg["control_dim"], u) + _dense(u, u)
    for m in mods:
        total += _encoders(cfg, m) + _dense(u * len(m), u)
    total += _encoders(cfg, ("image", "pos", "sensors")) + _dense(3 * u, u)
    total += cfg["gate_fusion_resblocks"] * 2 * _dense(u, u) + _dense(u, len(mods))
    return total


def particle_step_macs2(cfg) -> int:
    """One particle through one step: the dynamics trunk (its state
    encoder, the state half of dense_in, three resblocks, the output of
    D + 1) and each modality model's trunk (its state encoder, the state
    half of dense_in, two resblocks, the output of 1)."""
    u, d, k = cfg["units"], cfg["state_dim"], len(cfg["measurement_modalities"])
    dyn = _mlp(d, u) + _dense(u, u) + 6 * _dense(u, u) + _dense(u, d + 1)
    return dyn + k * (_mlp(d, u) + _dense(u, u) + 4 * _dense(u, u) + _dense(u, 1))


def particle_step_flops(cfg) -> int:
    """``particle_step_macs2`` plus about 20 operations a slot for the
    fusion and the tail and 4 a modality (B3's count in chip_smoke.py)."""
    return particle_step_macs2(cfg) + 20 + 4 * len(cfg["measurement_modalities"])


def eval_request_flops(cfg, t: int, n: int, m: int) -> int:
    """One eval request: T*N frames and T*N*M particle-steps."""
    return t * n * frame_macs2(cfg) + t * n * m * particle_step_flops(cfg)


def train_step_flops(cfg, b: int, seq_len: int, m: int) -> int:
    """One optimizer step of end-to-end training: the forward over the
    B*(L-1) frames after the first and B*(L-1)*M particle-steps, and the
    backward counted as twice the forward."""
    frames = b * (seq_len - 1)
    forward = frames * frame_macs2(cfg) + frames * m * particle_step_flops(cfg)
    return 3 * forward


def _bound_s(nbytes: float, ops: float) -> float:
    return max(nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S)


def tail_bytes(n: int, m: int, d: int) -> int:
    """B1: lw, ll, u, particles in; particles', lw', estimate out."""
    return 4 * (n * m * (3 + 2 * d + 1) + n * d)


def tail_bound_s(n: int, m: int, d: int) -> float:
    """B1's least time (multinomial): its bytes against its operations."""
    ops = n * m * (7 + 2 * d + max(1, m.bit_length()))
    return _bound_s(tail_bytes(n, m, d), ops)


def b2_bound_s(n: int, m: int, d: int, backward: bool) -> float:
    """B2f: lw, ll, particles in, lw', estimate out; 8 + 2D operations a
    particle. B2b: lw', particles, estimate, g_lw', g_est in, g_s, g_x out;
    6 + 3D operations a particle."""
    if backward:
        nbytes, ops = 4 * (n * m * (3 + 2 * d) + 2 * n * d), n * m * (6 + 3 * d)
    else:
        nbytes, ops = 4 * (n * m * (3 + d) + n * d), n * m * (8 + 2 * d)
    return _bound_s(nbytes, ops)


def b3_ops(cfg, t: int, n: int, m: int) -> int:
    return t * n * m * particle_step_flops(cfg)


def b3_bytes(cfg, t: int, n: int, m: int) -> int:
    """Noise, uniforms, the hoisted rows and gate, the trunks' weights and
    biases, the belief in and out, the estimates."""
    u, d, k = cfg["units"], cfg["state_dim"], len(cfg["measurement_modalities"])
    weights = 11 * u * (u + 1) + k * 9 * u * (u + 1)
    return 4 * (t * n * m * (d + 1) + t * n * ((1 + k) * u + k) + weights
                + 2 * n * m * (d + 1) + t * n * d)


def b3_bound_s(cfg, t: int, n: int, m: int) -> float:
    return _bound_s(b3_bytes(cfg, t, n, m), b3_ops(cfg, t, n, m))
