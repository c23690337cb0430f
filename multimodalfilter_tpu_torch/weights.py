"""Flax param trees -> state dicts of the port's modules, and seeded init.

Rules (the method of ``scripts/parity/torch_door_ekf.py``, in the other
direction from ``multimodalfilter_tpu/experiments/torch_import.py``):

  * a Dense kernel (in, out) becomes ``weight`` (out, in);
  * a Conv kernel in HWIO becomes OIHW;
  * the image encoder's ``dense`` kernel has its rows permuted once from
    flax's NHWC flatten order (h, w, c) to the NCHW order (c, h, w) in which
    ``models/encoders.py`` flattens its activation; for the spanning variant
    from each pool's (position, c) order to (c, position).

The state-dict key of a leaf is its flax path joined with dots. Every leaf is
consumed and every module parameter filled: ``load_jax_params`` raises on
anything left over in either direction.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Dict

import numpy as np
import torch
from torch import nn

def _tensor(arr: np.ndarray) -> torch.Tensor:
    """A contiguous, writable copy (flax leaves may be read-only views)."""
    return torch.from_numpy(np.array(arr, dtype=np.float32, order="C", copy=True))


def _dense_kernel(kernel: np.ndarray, image_encoder: Mapping = None) -> np.ndarray:
    if image_encoder is not None:
        c = np.asarray(image_encoder["conv3"]["kernel"]).shape[-1]
        hw = kernel.shape[0] // c
        side = int(round(hw ** 0.5))
        if side * side * c == kernel.shape[0]:
            # (h*w*c, u) rows in NHWC order -> (c*h*w, u) rows in NCHW order.
            kernel = (
                kernel.reshape(side, side, c, -1).transpose(2, 0, 1, 3)
                .reshape(kernel.shape[0], -1)
            )
        elif hw % 2 == 0:
            # The spanning variant: two pools of hw/2 positions each, rows
            # (position, c) -> (c, position) within each pool.
            pools = kernel.reshape(2, hw // 2, c, -1).transpose(0, 2, 1, 3)
            kernel = pools.reshape(kernel.shape[0], -1)
        else:
            raise ValueError(f"image dense kernel {kernel.shape} fits no encoder variant")
    return kernel.T


def params_from_jax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """Nested flax param dict (numpy or jax arrays) -> fp32 state dict."""
    out: Dict[str, torch.Tensor] = {}

    def walk(node: Mapping, path: tuple, parent: Mapping):
        for name, value in node.items():
            if isinstance(value, Mapping):
                walk(value, path + (str(name),), node)
                continue
            arr = np.asarray(value, dtype=np.float32)
            key = ".".join(path)
            if name == "bias":
                out[f"{key}.bias"] = _tensor(arr)
            elif name == "kernel" and arr.ndim == 4:
                out[f"{key}.weight"] = _tensor(arr.transpose(3, 2, 0, 1))
            elif name == "kernel" and arr.ndim == 2:
                # The image encoder's dense: the "dense" beside a "conv3".
                image_encoder = (
                    parent if path and path[-1] == "dense" and "conv3" in parent
                    else None
                )
                out[f"{key}.weight"] = _tensor(_dense_kernel(arr, image_encoder))
            else:
                raise ValueError(
                    f"unexpected flax leaf {'/'.join(path + (str(name),))} "
                    f"with shape {arr.shape}"
                )

    walk(tree, (), tree)
    return out


def load_jax_params(module: nn.Module, tree: Mapping) -> None:
    """Copy a flax param tree into `module` (on whatever device it lives).
    Raises on a leaf with no parameter, a parameter with no leaf, or a
    shape mismatch."""
    module.load_state_dict(params_from_jax(tree), strict=True)


# The standard deviation of a unit normal cut at +-2 (flax's
# variance_scaling divides by it so that the cut draw keeps variance
# scale / fan_in).
_TRUNCATED_NORMAL_STD = 0.87962566103423978


@torch.no_grad()
def init_params(module: nn.Module, seed: int) -> None:
    """Seeded init as flax's defaults: every weight drawn as
    ``lecun_normal`` draws it (a normal cut at two standard deviations,
    std sqrt(1/fan_in) / 0.8796..., so its variance is 1/fan_in and no
    draw lies beyond 2.27/sqrt(fan_in)), zero biases; except an LSTM cell's
    recurrent kernels (a module's ``recurrent_kernels``), each an orthogonal
    matrix as flax's ``recurrent_kernel_init`` draws it. Drawn on the CPU,
    so a seed gives the same weights on every device."""
    generator = torch.Generator().manual_seed(seed)
    orthogonal = {
        f"{prefix}.{name}.weight" if prefix else f"{name}.weight"
        for prefix, sub in module.named_modules()
        for name in getattr(sub, "recurrent_kernels", ())
    }
    for name, p in module.named_parameters():
        if name.endswith("bias"):
            p.zero_()
            continue
        draw = torch.empty(p.shape)
        if name in orthogonal:
            torch.nn.init.orthogonal_(draw, generator=generator)
        else:
            std = p[0].numel() ** -0.5 / _TRUNCATED_NORMAL_STD
            torch.nn.init.trunc_normal_(draw, std=std, a=-2 * std, b=2 * std,
                                        generator=generator)
        p.copy_(draw)
