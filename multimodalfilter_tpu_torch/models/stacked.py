"""Multi-instance image-encoder stacking (port of
``multimodalfilter_tpu/models/stacked.py``).

The fusion models run K independent copies of the same image encoder on the
same frames (the crossmodal PF's image measurement model and its gate; the
crossmodal KF's image virtual sensor and its gate). ``stacked_image_features``
runs the K copies as one pass:

  conv1: the input is shared, so the K kernels concatenate on the output
         channels into one 1 -> K*32 convolution;
  resblock, conv2, conv3: grouped convolutions (groups=K), block-diagonal
         over the encoders, each group's math the encoder's own;
  folded tail: one batched (K, N, 16*32*32) x (K, 16*32*32, u) product, the
         math of the JAX package's grouped 32x32 VALID convolution;
  unfolded tail: each encoder's [pool/]flatten and dense;
  final LinearResblock: one batched (K, u, u) product a layer.

Parameters are untouched: this is an execution transform over the existing
encoders (behind ``MMF_TPU_STACK_ENC=1`` / ``with_stacked_encoders``), with
the same compute dtype and fold as each encoder alone. Encoders stack only
where their architecture and options agree (``encoder_stack_config``);
mixed configurations fall back to the per-instance encoders.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from .encoders import IMAGE_SIZE, ImageEncoder, dual_spanning_avg_pool, fold_tail_weights
from .resblocks import linear


def _conv(x, weight, bias, dtype, padding: int, groups: int = 1):
    """A convolution under the compute `dtype`, as ``resblocks.conv``."""
    if dtype is None:
        return F.conv2d(x, weight, bias, padding=padding, groups=groups)
    y = F.conv2d(x.to(dtype), weight.to(dtype), None, padding=padding, groups=groups)
    return y + bias.to(dtype)[:, None, None]


def stacked_image_features(encoders: Sequence[ImageEncoder], images, *, dtype=None,
                           fold_tail: bool = False) -> Tuple[torch.Tensor, ...]:
    """K same-architecture encoders over the same frames (N, 32, 32) in one
    pass. Returns K features (N, units), each the encoder's own output up to
    summation order, in `dtype` when one is given."""
    k = len(encoders)
    if k < 2:
        raise ValueError("stacking needs at least two encoders")

    def cat(get):
        return torch.cat([get(e) for e in encoders])

    def stack(get):
        weight = torch.stack([get(e) for e in encoders])
        return weight if dtype is None else weight.to(dtype)

    spanning = encoders[0].spanning_avg_pool
    x = images[:, None]
    x = torch.relu(_conv(x, cat(lambda e: e.conv1.weight), cat(lambda e: e.conv1.bias),
                         dtype, padding=2))
    residual = x
    for blk in ("block1", "block2"):
        x = torch.relu(_conv(
            x, cat(lambda e: getattr(e.resblock_conv, blk).weight),
            cat(lambda e: getattr(e.resblock_conv, blk).bias), dtype, padding=1, groups=k))
    x = x + residual
    x = torch.relu(_conv(x, cat(lambda e: e.conv2.weight), cat(lambda e: e.conv2.bias),
                         dtype, padding=1, groups=k))
    n = x.shape[0]

    if fold_tail and x.shape[-2:] == (IMAGE_SIZE, IMAGE_SIZE):
        folded = [fold_tail_weights(e.conv3, e.dense, spanning) for e in encoders]
        weight = torch.stack([w for w, _ in folded]).to(x.dtype)  # (K, u, F)
        bias = torch.cat([b for _, b in folded]).to(x.dtype)
        y = torch.bmm(x.reshape(n, k, -1).transpose(0, 1), weight.transpose(1, 2))
        x = y.transpose(0, 1).reshape(n, -1) + bias
    else:
        x = _conv(x, cat(lambda e: e.conv3.weight), cat(lambda e: e.conv3.bias),
                  dtype, padding=1, groups=k)
        c3 = x.shape[1] // k
        outs = []
        for g, e in enumerate(encoders):
            xg = x[:, g * c3:(g + 1) * c3]
            xg = dual_spanning_avg_pool(xg) if spanning else xg.flatten(1)
            outs.append(linear(e.dense, xg, dtype))
        x = torch.cat(outs, dim=-1)
    x = torch.relu(x)

    xk = residual = x.reshape(n, k, -1)
    for blk in ("block1", "block2"):
        weight = stack(lambda e: getattr(e.resblock, blk).weight)  # (K, out, in)
        bias = stack(lambda e: getattr(e.resblock, blk).bias)
        xk = torch.relu(torch.einsum("nku,kvu->nkv", xk, weight) + bias)
    xk = xk + residual
    return tuple(xk[:, g] for g in range(k))


def image_encoder(net) -> Optional[ImageEncoder]:
    """The image encoder inside a consumer network's observation encoders,
    or None where the net encodes no image."""
    return getattr(getattr(net, "obs_encoders", None), "image_encoder", None)


def encoder_stack_config(net, dtype, fold_tail: bool) -> Optional[tuple]:
    """The stacking signature (units, spanning_avg_pool, dtype, fold_tail)
    of a net run under a def's `dtype` and `fold_tail`, or None when the net
    encodes no image. Two nets stack where their signatures are equal."""
    enc = image_encoder(net)
    if enc is None:
        return None
    return (enc.units, enc.spanning_avg_pool, dtype, bool(fold_tail))
