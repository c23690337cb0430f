"""Host and device conversions over trees of arrays (port of
``multimodalfilter_tpu/utils/conversions.py``; the reference's
``fannypack.utils.{to_torch, to_numpy}``, crossmodal/eval_helpers.py:100-106,
152-157). A tree is a tensor or array, or a dict, list, tuple or NamedTuple
of trees; other leaves pass through."""

from __future__ import annotations

import numpy as np
import torch


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def to_device(tree, device=None):
    """Numpy arrays in a tree as tensors (on `device` where one is given,
    which tensors are moved to as well)."""

    def convert(x):
        if isinstance(x, (np.ndarray, np.generic)):
            x = torch.as_tensor(x)
        if device is not None and isinstance(x, torch.Tensor):
            x = x.to(device)
        return x

    return _map(convert, tree)


def to_numpy(tree):
    """Tensors in a tree as numpy arrays on the host."""
    return _map(lambda x: x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x,
                tree)
