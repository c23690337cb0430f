"""Stateful filter facade, the particle-filter subset (port of
``multimodalfilter_tpu/filtering/wrappers.py``).

``StatefulFilter`` holds a filter def, its parameters (``params``: the
module tree whose state-dict keys are the flax param paths, loadable with
``weights.load_jax_params``), the current belief, a seeded
``torch.Generator`` on the model's device, the enabled-modality mask, the
set of frozen parameter paths and the set of loop configurations already
run (``loop_cache_key``, which the eval's warm-up reads). ``ModuleHandle``
is a view of a submodule
(``filter_model.measurement_model.crossmodal_weight_model``): its dotted
path and sub-def, which is what the train loops and ``freeze_module`` need.
``apply_serving_knobs`` reads the ``MMF_TPU_*`` serving knobs.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, List, Optional, Tuple

import torch

from .._device import Device, resolve_device
from ..utils.precision import with_fused_step
from ..weights import init_params, load_jax_params


def _join(path: str, name: str) -> str:
    return f"{path}.{name}" if path else name


class ModuleHandle:
    """View of a submodule of a StatefulFilter: (root, dotted path, sub-def)."""

    def __init__(self, root: "StatefulFilter", path: str, definition):
        self.root = root
        self.path = path
        self.definition = definition

    @property
    def params(self) -> torch.nn.Module:
        return self.root.params.get_submodule(self.path)

    @property
    def enabled_models(self) -> Optional[List[bool]]:
        return self.root.enabled_models

    @enabled_models.setter
    def enabled_models(self, value: List[bool]):
        self.root.enabled_models = value

    def __getattr__(self, name: str):
        if name.startswith("_"):
            raise AttributeError(name)
        return _child_accessor(self.root, self.path, self.definition, name)

    def __repr__(self):
        return f"ModuleHandle({self.path!r}, {type(self.definition).__name__})"


class _ListHandle:
    """Handle over a tuple field of a def (the reference's nn.ModuleList)."""

    def __init__(self, root, path: str, items: Tuple[Any, ...]):
        self.root = root
        self.path = path
        self.items = items

    def __len__(self):
        return len(self.items)

    def __getitem__(self, index: int) -> ModuleHandle:
        return ModuleHandle(self.root, _join(self.path, str(index)), self.items[index])

    def __iter__(self):
        return (self[i] for i in range(len(self)))


def _child_accessor(root, path: str, definition, name: str):
    if dataclasses.is_dataclass(definition):
        for field in dataclasses.fields(definition):
            if field.name == name:
                value = getattr(definition, name)
                child_path = _join(path, name)
                if isinstance(value, tuple):  # e.g. measurement_models
                    return _ListHandle(root, child_path, value)
                if dataclasses.is_dataclass(value) and hasattr(value, "module"):
                    return ModuleHandle(root, child_path, value)
                return value
    raise AttributeError(
        f"{type(definition).__name__} has no submodule/attribute {name!r}"
    )


# Knobs the port does not serve yet: (env name, on under MMF_TPU_SERVING=1,
# what it promises, the ROADMAP item that ports it).
_UNPORTED_KNOBS = (
    ("MMF_TPU_BF16", True, "bf16 encoder compute", "A8"),
    ("MMF_TPU_FOLD_ENC", True, "the folded image-encoder tail", "A8"),
    ("MMF_TPU_STACK_ENC", False, "channel-stacked image encoders", "A12"),
)


def apply_serving_knobs(definition):
    """The JAX facade's serving knobs, read from the environment
    (wrappers.py:160-239 of the JAX package):

    - ``MMF_TPU_FUSED_STEP=1`` applies ``with_fused_step``: the eval
      forward_loop of a qualifying particle filter runs as one kernel, B3.
    - ``MMF_TPU_PALLAS`` is accepted and has no effect: the port always runs
      its kernels on CUDA tensors.
    - ``MMF_TPU_SCAN_UNROLL`` is accepted (an integer, as in JAX) and has no
      effect: the port's forward_loop is a Python loop, with no scan to
      unroll.
    - ``MMF_TPU_BF16``, ``MMF_TPU_FOLD_ENC``, ``MMF_TPU_STACK_ENC`` and
      ``MMF_TPU_SERVING`` (which turns on BF16 and FOLD_ENC unless they are
      set to 0) raise ``NotImplementedError`` naming the ROADMAP item, rather
      than serve in a precision or layout the knob did not promise.
    """
    serving = os.environ.get("MMF_TPU_SERVING", "0") == "1"

    def knob(name: str, default_on: bool) -> bool:
        return os.environ.get(name, "1" if default_on else "0") == "1"

    int(os.environ.get("MMF_TPU_SCAN_UNROLL", "1"))
    for name, under_serving, what, item in _UNPORTED_KNOBS:
        if knob(name, serving and under_serving):
            via = " (through MMF_TPU_SERVING=1)" if name not in os.environ else ""
            raise NotImplementedError(
                f"{name}=1{via} asks for {what}, which the PyTorch port does not "
                f"have yet (ROADMAP {item}); unset it to serve in fp32"
            )
    if knob("MMF_TPU_FUSED_STEP", False):
        definition = with_fused_step(definition, True)
    return definition


class StatefulFilter:
    """Stateful facade over a filter def. The serving knobs ``MMF_TPU_*``
    are read from the environment at construction
    (``apply_serving_knobs``)."""

    def __init__(self, definition, *, device: Device = None, seed: int = 0):
        definition = apply_serving_knobs(definition)
        self.device = resolve_device(device)
        self.definition = definition
        self.params = definition.module()
        init_params(self.params, seed)
        # Draws of the belief, noise and uniforms, on the model's device.
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self._training = True
        self._belief = None
        # Loop configurations already run (loop_cache_key): the eval runs one
        # discarded loop before it times a new one.
        self._loops_run: set = set()
        self.frozen_paths: set = set()
        count = len(getattr(definition.measurement_model, "measurement_models", ()))
        self._enabled_models: Optional[List[bool]] = [True] * count if count else None

    # -- mode / config ------------------------------------------------------
    def train(self, mode: bool = True):
        self._training = mode
        self.params.train(mode)
        return self

    def eval(self):
        return self.train(False)

    @property
    def training(self) -> bool:
        return self._training

    @property
    def enabled_models(self) -> Optional[List[bool]]:
        return self._enabled_models

    @enabled_models.setter
    def enabled_models(self, value: List[bool]):
        if self._enabled_models is None:
            raise AttributeError("Not a fusion filter")
        if len(value) != len(self._enabled_models):
            raise ValueError(f"expected {len(self._enabled_models)} flags")
        self._enabled_models = list(value)

    @property
    def _enabled_tuple(self) -> Optional[Tuple[bool, ...]]:
        return tuple(self._enabled_models) if self._enabled_models else None

    @property
    def state_dim(self) -> int:
        return self.definition.state_dim

    @property
    def know_image_blackout(self) -> bool:
        gate = getattr(self.definition.measurement_model, "crossmodal_weight_model", None)
        return bool(gate is not None and gate.know_image_blackout)

    @know_image_blackout.setter
    def know_image_blackout(self, value: bool):
        """Scripts flip this after construction
        (``scripts/door_task/train_door.py:73``); defs are frozen, so the def is rebuilt with the flag. Its networks, and so
        ``params``, are kept. A def with no gate ignores it, as in JAX."""
        mm = self.definition.measurement_model
        gate = getattr(mm, "crossmodal_weight_model", None)
        if gate is not None:
            self.definition = dataclasses.replace(
                self.definition,
                measurement_model=dataclasses.replace(
                    mm, crossmodal_weight_model=dataclasses.replace(
                        gate, know_image_blackout=value)),
            )
        self._loops_run.clear()

    def num_parameters(self) -> int:
        return sum(p.numel() for p in self.params.parameters())

    def loop_cache_key(self, batch: int):
        """The configuration the next ``forward_loop`` over `batch`
        trajectories runs in: (mode, enabled modalities, batch, def). The
        JAX facade keys its compiled loops so; here a key first run pays the
        kernels' build and cuDNN's first calls, which the eval's warm-up
        (``crossmodal/_eval_throughput.warm_up_loop``) keeps out of the
        timed run."""
        return (self._training, self._enabled_tuple, batch, id(self.definition))

    # -- submodule handles ------------------------------------------------------
    def __getattr__(self, name: str):
        # Only called when normal attribute lookup fails.
        if name.startswith("_") or "definition" not in self.__dict__:
            raise AttributeError(name)
        return _child_accessor(self, "", self.__dict__["definition"], name)

    def load_jax_params(self, tree) -> None:
        """Copy a JAX model's param tree into this model."""
        load_jax_params(self.params, tree)

    # -- filter API -----------------------------------------------------------
    @property
    def belief(self):
        return self._belief

    @belief.setter
    def belief(self, value):
        self._belief = value

    def _to_device(self, x):
        """Numpy arrays or tensors (or a dict of them) -> fp32 on our device."""
        if isinstance(x, dict):
            return {k: self._to_device(v) for k, v in x.items()}
        return torch.as_tensor(x, dtype=torch.float32, device=self.device)

    def initialize_beliefs(self, *, mean, covariance):
        with torch.no_grad():
            self._belief = self.definition.initialize_beliefs(
                self._to_device(mean), self._to_device(covariance),
                train=self._training, generator=self.generator,
            )

    def forward(self, *, observations, controls, eps=None, uniforms=None):
        """One filter step: observations dict of (N, ...), controls (N, C).
        Returns the estimate (N, D) and keeps the new belief. Pre-drawn
        `eps` (N*M, D) and `uniforms` (N, M) replace the generator's draws
        (to replay a run)."""
        if self._belief is None:
            raise RuntimeError("Call initialize_beliefs first")
        self._belief, estimate = self.definition.step(
            self._belief, self._to_device(observations), self._to_device(controls),
            train=self._training, enabled=self._enabled_tuple,
            eps=None if eps is None else self._to_device(eps),
            uniforms=None if uniforms is None else self._to_device(uniforms),
            generator=self.generator,
        )
        return estimate

    def forward_loop(self, *, observations, controls, eps_seq=None,
                     uniforms_seq=None):
        """observations: dict of (T, N, ...); controls (T, N, C). Returns
        estimates (T, N, D) and keeps the final belief. Pre-drawn `eps_seq`
        and `uniforms_seq` replace the generator's draws (to replay a run)."""
        if self._belief is None:
            raise RuntimeError("Call initialize_beliefs first")
        self._belief, estimates = self.definition.forward_loop(
            self._belief, self._to_device(observations), self._to_device(controls),
            train=self._training, enabled=self._enabled_tuple,
            eps_seq=None if eps_seq is None else self._to_device(eps_seq),
            uniforms_seq=None if uniforms_seq is None else self._to_device(uniforms_seq),
            generator=self.generator,
        )
        self._loops_run.add(self.loop_cache_key(estimates.shape[1]))
        return estimates


def _root_and_path(module):
    if isinstance(module, (ModuleHandle, _ListHandle)):
        return module.root, module.path
    return module, ""


def freeze_module(module) -> None:
    """Mark a filter's or handle's parameters as frozen for subsequent
    training (fannypack.utils.freeze_module; train_door.py:144,158)."""
    root, path = _root_and_path(module)
    root.frozen_paths.add(path)


def unfreeze_module(module) -> None:
    root, path = _root_and_path(module)
    root.frozen_paths.discard(path)
