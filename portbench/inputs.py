"""Everything a run feeds the program and the reference, made from the
seed on the run's device: the weights (in the parameter layout of
``reference/nets.param_spec``) and the inputs of each traffic mix.

The same seed gives the same tensors on the same device. Each stream has
its own generator seeded from (seed, tag), so adding a stream moves no
other one. Weights are one normal draw for the whole model, split and
scaled per leaf: a weight by 1/sqrt(fan_in) (the published models' LeCun
normal initialisation), a bias by the configuration's ``init.bias_std``,
and a layer named in ``init.layer_scale`` by its factor.
"""

from __future__ import annotations

import hashlib
import math
from typing import Dict

import torch

from .reference import nets


def stream_seed(seed: int, tag: str) -> int:
    """A 63-bit generator seed for stream `tag` of run seed `seed`."""
    digest = hashlib.sha256(f"{int(seed)}:{tag}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def generator(seed: int, tag: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(stream_seed(seed, tag))


def make_weights(cfg, seed: int, device) -> Dict[str, torch.Tensor]:
    spec = nets.param_spec(cfg)
    init = cfg.get("init", {})
    scales = init.get("layer_scale", {})
    bias_std = float(init.get("bias_std", 0.0))
    total = sum(math.prod(shape) for _, shape in spec)
    flat = torch.randn(total, generator=generator(seed, "weights", device), device=device)
    out, offset = {}, 0
    for name, shape in spec:
        size = math.prod(shape)
        x = flat[offset:offset + size].view(shape)
        offset += size
        layer, kind = name.rsplit(".", 1)
        factor = bias_std if kind == "bias" else (size // shape[0]) ** -0.5
        out[name] = (x * (factor * float(scales.get(layer, 1.0)))).contiguous()
    return out


def observations(cfg, lead: tuple, g: torch.Generator, device) -> Dict[str, torch.Tensor]:
    """Normal frames of every modality with leading shape `lead`."""
    side = cfg["image_size"]
    return {
        "image": torch.randn(lead + (side, side), generator=g, device=device),
        "gripper_pos": torch.randn(lead + (cfg["pos_dim"],), generator=g, device=device),
        "gripper_sensors": torch.randn(lead + (cfg["sensors_dim"],), generator=g,
                                       device=device),
    }


def eval_request_inputs(cfg, traffic, seed: int, index: int, device):
    """Pool entry `index` of an eval mix: observations and controls
    (T, N, ...), the initial belief's mean (N, D) and covariance
    (N, D, D), and the loop's draws: eps_seq (T, N*M, D), uniforms
    (T, N, M)."""
    t, n, m, d = traffic["T"], traffic["N"], traffic["M"], cfg["state_dim"]
    g = generator(seed, f"pool{index}", device)
    obs = observations(cfg, (t, n), g, device)
    controls = torch.randn((t, n, cfg["control_dim"]), generator=g, device=device)
    mean = torch.randn((n, d), generator=g, device=device)
    cov = traffic["initial_cov_scale"] * torch.eye(d, device=device).expand(n, d, d)
    eps_seq = torch.randn((t, n * m, d), generator=g, device=device)
    uniforms = torch.rand((t, n, m), generator=g, device=device)
    return {"obs": obs, "controls": controls, "mean": mean, "cov": cov.contiguous(),
            "eps_seq": eps_seq, "uniforms": uniforms}


def train_subsequences(cfg, traffic, seed: int, device):
    """The training set: S subsequences of L steps. States are random
    walks (normal start, steps of ``state_step_std``); every other input
    is normal."""
    s, seq_len, d = traffic["subsequences"], traffic["L"], cfg["state_dim"]
    g = generator(seed, "train_set", device)
    start = torch.randn((s, 1, d), generator=g, device=device)
    steps = traffic["state_step_std"] * torch.randn((s, seq_len - 1, d), generator=g,
                                                    device=device)
    states = torch.cat([start, start + torch.cumsum(steps, dim=1)], dim=1)
    obs = observations(cfg, (s, seq_len), g, device)
    controls = torch.randn((s, seq_len, cfg["control_dim"]), generator=g, device=device)
    return {"states": states.contiguous(), "controls": controls, "obs": obs}
