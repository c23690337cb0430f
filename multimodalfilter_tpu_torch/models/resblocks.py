"""Residual blocks (port of ``multimodalfilter_tpu/models/resblocks.py``).

    y = x + relu(W2 @ relu(W1 @ x))

Convolutions are NCHW, PyTorch's layout; the JAX package works in NHWC.

Every forward takes a compute ``dtype`` (None: fp32), an execution option of
the caller's, never an attribute of the module: the parameters stay fp32 and
are shared by defs that compute in different dtypes. Under a dtype each layer
computes as flax's ``Dense``/``Conv(dtype=...)`` does: input, kernel and bias
cast to the dtype, the product rounded to it, then the bias added in it; the
ReLUs and the residual adds run in it too.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def linear(layer: nn.Linear, x, dtype=None):
    """`layer`(x) under the compute `dtype` (None: the layer as it is)."""
    if dtype is None:
        return layer(x)
    y = F.linear(x.to(dtype), layer.weight.to(dtype))
    return y if layer.bias is None else y + layer.bias.to(dtype)


def conv(layer: nn.Conv2d, x, dtype=None):
    """`layer`(x) under the compute `dtype` (None: the layer as it is)."""
    if dtype is None:
        return layer(x)
    y = F.conv2d(x.to(dtype), layer.weight.to(dtype), None, layer.stride,
                 layer.padding, layer.dilation, layer.groups)
    return y if layer.bias is None else y + layer.bias.to(dtype)[:, None, None]


class LinearResblock(nn.Module):
    def __init__(self, units: int, *, device=None):
        super().__init__()
        self.block1 = nn.Linear(units, units, device=device)
        self.block2 = nn.Linear(units, units, device=device)

    def forward(self, x, *, dtype=None):
        h = torch.relu(linear(self.block1, x, dtype))
        return x + torch.relu(linear(self.block2, h, dtype))


class Conv2dResblock(nn.Module):
    """Residual 3x3 conv block over NCHW inputs, "SAME" padding."""

    def __init__(self, channels: int, *, device=None):
        super().__init__()
        self.block1 = nn.Conv2d(channels, channels, 3, padding=1, device=device)
        self.block2 = nn.Conv2d(channels, channels, 3, padding=1, device=device)

    def forward(self, x, *, dtype=None):
        h = torch.relu(conv(self.block1, x, dtype))
        return x + torch.relu(conv(self.block2, h, dtype))
