"""Observation/state/control encoders (port of
``multimodalfilter_tpu/models/encoders.py``):

  MLP encoders:  Dense(units) -> ReLU -> LinearResblock(units)
  Image encoder: Conv5x5(32) -> ReLU -> Conv2dResblock(32,k3) ->
                 Conv3x3(16) -> ReLU -> Conv3x3(8) -> flatten(8192) ->
                 Dense(units) -> ReLU -> LinearResblock(units)
  Image encoder (spanning_avg_pool=True, the push task's variant):
                 ... -> Conv3x3(2) -> dual spanning avg-pool (full-height +
                 full-width, reduce 2) -> Dense(units) -> ReLU -> resblock

The image encoder flattens its NCHW activation in (c, h, w) order, and the
spanning variant its two pools in (c, w) and (c, h) order; the flax encoder
flattens NHWC in (h, w, c) order and its pools in (w, c) and (h, c) order.
``weights.py`` permutes the rows of the flax ``dense`` kernel once, so no
activation is permuted per call.

Two execution options of the caller's, never module attributes (defs that
share these modules may compute differently): a compute ``dtype`` (see
``resblocks.py``; parameters stay fp32), and ``fold_tail``, which applies the
linear conv3 -> [pool] -> dense tail as one product with the weight that
``fold_tail_weights`` composes from the current parameters.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .resblocks import Conv2dResblock, LinearResblock, conv, linear

IMAGE_SIZE = 32
POOL_REDUCE = 2  # the spanning pools' window across the spanned axis


class MLPEncoder(nn.Module):
    """Dense -> ReLU -> LinearResblock."""

    def __init__(self, in_features: int, units: int, *, device=None):
        super().__init__()
        self.dense = nn.Linear(in_features, units, device=device)
        self.resblock = LinearResblock(units, device=device)

    def forward(self, x, *, dtype=None):
        return self.resblock(torch.relu(linear(self.dense, x, dtype)), dtype=dtype)


def dual_spanning_avg_pool(x, reduce_size: int = POOL_REDUCE):
    """Two average pools of an NCHW activation, one spanning its full height
    (windows of `reduce_size` columns), one its full width; each flattened in
    (c, position) order, then concatenated (JAX encoders.py:49-58)."""
    n, _, h, w = x.shape
    pooled_h = F.avg_pool2d(x, (h, reduce_size))  # (N, C, 1, W / r)
    pooled_w = F.avg_pool2d(x, (reduce_size, w))  # (N, C, H / r, 1)
    return torch.cat([pooled_h.reshape(n, -1), pooled_w.reshape(n, -1)], dim=-1)


def fold_tail_weights(conv3: nn.Conv2d, dense: nn.Linear, spanning_avg_pool: bool):
    """Compose the linear conv3 -> [pool] -> flatten -> dense tail into one
    map from the flattened conv2 activation (16*32*32, (c, h, w) order) to
    `units`: (weight (u, 16*32*32), bias (u,)), fp32 (JAX encoders.py:61-110).

    No ReLU lies between conv3 and the dense, so the composition is exact up
    to summation order. The dense weight, un-pooled onto the conv3 grid for
    the spanning variant, goes through conv3's transpose: its nine shifted
    copies, one a tap, contracted with conv3's taps in one product. Built in
    float64 from the current parameters and rounded to fp32 once, so TF32
    never enters it whatever the global flags (the JAX package builds it at
    Precision.HIGHEST), and gradients reach conv3 and the dense through it.
    """
    kd = dense.weight.double()
    u, c3 = kd.shape[0], conv3.weight.shape[0]
    side = IMAGE_SIZE
    if spanning_avg_pool:
        # Rows [0, c3*16) weigh the full-height pool, index (c, w // 2);
        # the rest the full-width pool, (c, h // 2); each averaged 64 pixels.
        half = side // POOL_REDUCE
        kd_h = kd[:, : c3 * half].reshape(u, c3, 1, half)
        kd_w = kd[:, c3 * half:].reshape(u, c3, half, 1)
        kd_eff = (kd_h.repeat_interleave(POOL_REDUCE, dim=3)
                  + kd_w.repeat_interleave(POOL_REDUCE, dim=2)) / (side * POOL_REDUCE)
    else:
        kd_eff = kd.reshape(u, c3, side, side)
    k3 = conv3.weight.double()  # (c3, 16, 3, 3)
    padded = F.pad(kd_eff, (1, 1, 1, 1))
    # W[u, i, h, w] = sum over c and taps (a, b) of kd[u, c, h + 1 - a,
    # w + 1 - b] k3[c, i, a, b], zero outside the grid.
    shifts = torch.stack([padded[:, :, 2 - a:2 - a + side, 2 - b:2 - b + side]
                          for a in range(3) for b in range(3)], dim=2)  # (u, c3, 9, h, w)
    weight = torch.einsum("uckhw,cik->uihw", shifts, k3.flatten(2))
    bias = dense.bias.double() + (kd_eff * conv3.bias.double()[:, None, None]).sum((1, 2, 3))
    return weight.flatten(1).float(), bias.float()


class ImageEncoder(nn.Module):
    """CNN encoder over (N, 32, 32) grayscale images: the door's flatten
    variant, or with ``spanning_avg_pool`` the push task's."""

    def __init__(self, units: int, spanning_avg_pool: bool = False, *, device=None):
        super().__init__()
        self.units = units
        self.spanning_avg_pool = spanning_avg_pool
        c3 = 2 if spanning_avg_pool else 8
        features = (c3 * 2 * IMAGE_SIZE // POOL_REDUCE if spanning_avg_pool
                    else c3 * IMAGE_SIZE * IMAGE_SIZE)
        self.conv1 = nn.Conv2d(1, 32, 5, padding=2, device=device)
        self.resblock_conv = Conv2dResblock(32, device=device)
        self.conv2 = nn.Conv2d(32, 16, 3, padding=1, device=device)
        self.conv3 = nn.Conv2d(16, c3, 3, padding=1, device=device)
        self.dense = nn.Linear(features, units, device=device)
        self.resblock = LinearResblock(units, device=device)

    def forward(self, images, *, dtype=None, fold_tail: bool = False):
        """images (N, 32, 32) -> (N, units), in `dtype` when one is given."""
        x = torch.relu(conv(self.conv1, images[:, None], dtype))
        x = self.resblock_conv(x, dtype=dtype)
        x = torch.relu(conv(self.conv2, x, dtype))  # (N, 16, 32, 32)
        if fold_tail and x.shape[-2:] == (IMAGE_SIZE, IMAGE_SIZE):
            weight, bias = fold_tail_weights(self.conv3, self.dense, self.spanning_avg_pool)
            x = F.linear(x.flatten(1), weight.to(x.dtype)) + bias.to(x.dtype)
        else:
            x = conv(self.conv3, x, dtype)
            x = dual_spanning_avg_pool(x) if self.spanning_avg_pool else x.flatten(1)
            x = linear(self.dense, x, dtype)
        return self.resblock(torch.relu(x), dtype=dtype)
