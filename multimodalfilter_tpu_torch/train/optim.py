"""Optimizer plumbing: named Adam optimizers and frozen-path gradient
masking (port of ``multimodalfilter_tpu/train/optim.py``).

The JAX package steps optax's Adam on a gradient for every leaf: zeros where
the loss does not reach a leaf (a disabled modality's model) and zeros again
under a frozen path; all leaves share one step count. ``torch.optim.Adam``
instead skips a parameter whose ``.grad`` is None and counts steps per
parameter. ``apply_gradients`` therefore gives every parameter a gradient
before each step, zeros where none reached it, so that a parameter whose
gradient is zero still moves on its decaying Adam moments as it does under
optax (the door curriculum's phase 3 keeps one optimizer across a switch of
``enabled_models``).
"""

from __future__ import annotations

from typing import Iterable

import torch
from torch import nn

DEFAULT_LEARNING_RATE = 1e-4  # fannypack Buddy's Adam default.


def make_optimizer(params, learning_rate: float = DEFAULT_LEARNING_RATE):
    """Adam with optax.adam's defaults (betas 0.9, 0.999; eps 1e-8 added
    outside the square root)."""
    return torch.optim.Adam(params, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8)


def _is_frozen(name: str, prefixes) -> bool:
    segments = tuple(name.split("."))
    return any(segments[: len(p)] == p for p in prefixes)


def zero_frozen_grads(module: nn.Module, frozen_paths: Iterable[str]) -> None:
    """Zero the gradients of parameters under any frozen dotted path of
    `module`'s state-dict keys ('' = everything)."""
    prefixes = [tuple(p.split(".")) if p else () for p in frozen_paths]
    if not prefixes:
        return
    for name, p in module.named_parameters():
        if p.grad is not None and _is_frozen(name, prefixes):
            p.grad.zero_()


def apply_gradients(optimizer: torch.optim.Optimizer, module: nn.Module,
                    frozen_paths: Iterable[str]) -> None:
    """One optimizer step over `module`: every missing ``.grad`` becomes
    zeros (never None), frozen paths' gradients are zeroed, then Adam
    steps."""
    for p in module.parameters():
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    zero_frozen_grads(module, frozen_paths)
    optimizer.step()


def load_optimizer_state(optimizer: torch.optim.Optimizer, saved) -> bool:
    """Load a saved ``state_dict()`` (Adam's moments and step counts) into
    `optimizer`, keeping its learning rates, as an optax state holds none.
    Returns False, and leaves `optimizer` as it was, where the state does
    not fit."""
    learning_rates = [group["lr"] for group in optimizer.param_groups]
    try:
        optimizer.load_state_dict(saved)
    except (KeyError, ValueError):
        return False
    for group, lr in zip(optimizer.param_groups, learning_rates):
        group["lr"] = lr
    return True


def get_named_optimizer(buddy, name: str, module: nn.Module,
                        learning_rate: float = DEFAULT_LEARNING_RATE):
    """Fetch-or-create a named Adam over ALL of `module`'s parameters in the
    buddy's clearable dict (as ``tx.init(root.params)`` does). A new one
    warm-starts from the state a loaded checkpoint stashed under its name
    (``Buddy.load_checkpoint``); a state that does not fit is dropped."""
    if name not in buddy._optimizer_dict:
        optimizer = make_optimizer(module.parameters(), learning_rate)
        saved = getattr(buddy, "_pending_optimizer_state", {}).pop(name, None)
        if saved is not None:
            load_optimizer_state(optimizer, saved)
        buddy._optimizer_dict[name] = optimizer
    return buddy._optimizer_dict[name]
