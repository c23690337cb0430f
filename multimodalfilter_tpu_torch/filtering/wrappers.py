"""Stateful filter facade (port of
``multimodalfilter_tpu/filtering/wrappers.py``).

``StatefulFilter`` holds a filter def, its parameters (``params``: the
module tree whose state-dict keys are the flax param paths, loadable with
``weights.load_jax_params``), the current belief, a seeded
``torch.Generator`` on the model's device, the enabled-modality mask, the
set of frozen parameter paths and the set of loop configurations already
run (``loop_cache_key``, which the eval's warm-up reads). ``ModuleHandle``
is a view of a submodule
(``filter_model.measurement_model.crossmodal_weight_model``,
``filter_model.filter_models[0].dynamics_model``): its dotted path and
sub-def, which is what the train loops and ``freeze_module`` need.
``apply_serving_knobs`` reads the ``MMF_TPU_*`` serving knobs.

On a mesh (``use_data_parallel``, ``use_pipeline``) ``forward_loop`` takes
and returns global arrays, as the JAX facade does, and each rank runs its
shard (``parallel/data_parallel.py::mesh_forward_loop``): every rank holds
the same belief and generator, so they draw the same global noise.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, List, Optional, Tuple

import torch

from .._device import Device, resolve_device
from ..types import GaussianBelief
from ..utils.debug import SPAN_FACADE_FORWARD_LOOP, SPAN_FACADE_INITIALIZE, span
from ..utils.precision import (
    with_compute_dtype,
    with_fold_tail,
    with_fused_step,
    with_stacked_encoders,
)
from ..utils.rng import prng_impl_from_env
from ..weights import init_params, load_jax_params
from .base import measurement_initialize


def pad_time_to_stages(observations, controls, stages: int):
    """Zero-pad the leading time axis of (observations (a tensor or a dict
    of them), controls) up to a multiple of `stages`: the padding rule of
    every pipelined rollout (``StatefulFilter.run_loop`` and the eval's
    chained timer), as in the JAX facade."""

    def pad(x):
        extra = (-x.shape[0]) % stages
        if not extra:
            return x
        return torch.cat([x, x.new_zeros((extra,) + tuple(x.shape[1:]))], dim=0)

    if isinstance(observations, dict):
        return {k: pad(v) for k, v in observations.items()}, pad(controls)
    return pad(observations), pad(controls)


# Tuple fields of the fused per-modality models (the reference's
# nn.ModuleLists).
_FUSION_FIELDS = ("filter_models", "measurement_models", "virtual_sensor_model")


def _fusion_count(definition) -> Optional[int]:
    """Number of fused per-modality models, searching the def tree (a PF
    whose measurement model is a crossmodal fusion; an EKF whose virtual
    sensor is one)."""
    if not dataclasses.is_dataclass(definition):
        return None
    for field in dataclasses.fields(definition):
        value = getattr(definition, field.name)
        if field.name in _FUSION_FIELDS and isinstance(value, tuple):
            return len(value)
        nested = _fusion_count(value)
        if nested is not None:
            return nested
    return None


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


def _knob(name: str, default_on: bool) -> bool:
    return os.environ.get(name, "1" if default_on else "0") == "1"


def apply_serving_knobs(definition):
    """The JAX facade's serving knobs, read from the environment, with its
    defaults and overrides (wrappers.py:160-239 of the JAX package):

    - ``MMF_TPU_SERVING=1`` is the serving stack in one switch: it turns on
      ``MMF_TPU_BF16`` and ``MMF_TPU_FOLD_ENC`` (and ``MMF_TPU_PALLAS``),
      each of which an explicit ``=0`` turns off again.
    - ``MMF_TPU_BF16=1`` applies ``with_compute_dtype(torch.bfloat16)``: the
      observation encoders compute in bf16, their features return in fp32.
    - ``MMF_TPU_FOLD_ENC=1`` applies ``with_fold_tail``: each image encoder's
      conv3 -> dense tail runs as one product.
    - ``MMF_TPU_STACK_ENC=1`` applies ``with_stacked_encoders``: the image
      encoders that read the same frame run as one stacked pass. Off by
      default and not part of the serving switch, as in the JAX package.
    - ``MMF_TPU_FUSED_STEP=1`` applies ``with_fused_step``: the eval
      forward_loop of a qualifying particle filter runs as one kernel, B3.
    - ``MMF_TPU_PALLAS`` is accepted and has no effect: the port always runs
      its kernels on CUDA tensors.
    - ``MMF_TPU_SCAN_UNROLL`` is accepted (an integer, as in JAX) and has no
      effect: the port's forward_loop is a Python loop, with no scan to
      unroll.
    - ``MMF_TPU_RBG`` is accepted when it leaves JAX's default PRNG (0, off)
      and refused otherwise (``utils/rng.py``): the port draws from
      ``torch.Generator``.

    Training strips the dtype, the fold and the stack again
    (``train/loops.py``), so a model built under the switch trains as a
    plain one and evaluates with the serving stack.
    """
    prng_impl_from_env()
    serving = os.environ.get("MMF_TPU_SERVING", "0") == "1"
    int(os.environ.get("MMF_TPU_SCAN_UNROLL", "1"))
    if _knob("MMF_TPU_BF16", serving):
        definition = with_compute_dtype(definition, torch.bfloat16)
    if _knob("MMF_TPU_FOLD_ENC", serving):
        definition = with_fold_tail(definition, True)
    if _knob("MMF_TPU_STACK_ENC", False):
        definition = with_stacked_encoders(definition, True)
    if _knob("MMF_TPU_FUSED_STEP", False):
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
        # The multi-device layout of forward_loop: (mesh, axis_name,
        # num_microbatches or None, data axis, particle axis) of the
        # pipeline, or the data-parallel mesh; None on one device.
        self._pipeline = None
        self._data_mesh = None
        # The fused per-modality models (none for a plain PF or EKF, or for
        # the LSTM).
        count = _fusion_count(definition)
        self._enabled_models: Optional[List[bool]] = [True] * count if count else None

    # -- mode / config ------------------------------------------------------
    def use_pipeline(self, mesh, axis_name: str = "pipe", num_microbatches=None):
        """Run ``forward_loop`` through the temporal pipeline: the time axis
        over `mesh`'s `axis_name`, the belief relayed stage to stage
        (``parallel/temporal_pipeline.py``). T is zero-padded to a multiple
        of the stage count and the padded estimates dropped; the stored
        belief is then that of the padded rollout (eval re-initialises it
        for every run). ``mesh=None`` turns it off.

        ``num_microbatches=None`` takes the largest divisor of the per-shard
        batch up to 8 when the loop runs. A "data" axis on the mesh splits
        the trajectories over it as well (the data x pipe grid); a
        "particle" axis splits a particle filter's particles inside each
        stage; all three compose."""
        if mesh is None:
            self._pipeline = None
            self._loops_run.clear()
            return
        from ..parallel.mesh import axis_names
        from .pf import ParticleFilterDef

        names = axis_names(mesh)
        if axis_name not in names:
            raise ValueError(
                f"the pipeline mesh has axes {names} and no {axis_name!r} axis: pass a "
                "mesh with a pipeline axis (create_mesh(4, ('pipe',)) or a ('data', "
                "'pipe') grid), or set axis_name to match")
        data_axis = "data" if "data" in names and axis_name != "data" else None
        particle_axis = "particle" if "particle" in names and axis_name != "particle" else None
        if particle_axis is not None:
            if not isinstance(self.definition, ParticleFilterDef):
                raise ValueError(
                    "a 'particle' mesh axis splits a particle filter's particles; "
                    f"{type(self.definition).__name__} cannot pipeline over it")
            import warnings

            warnings.warn(
                "particle-axis sharding resamples with collectives: B1, B4, B5 and B3 "
                "(and the serving tail) are bypassed inside the particle-sharded step",
                stacklevel=2)
        self._pipeline = (mesh, axis_name,
                          None if num_microbatches is None else int(num_microbatches),
                          data_axis, particle_axis)
        self._loops_run.clear()

    def use_data_parallel(self, mesh, axis_name: str = "data"):
        """Split ``forward_loop``'s trajectories over `mesh`'s `axis_name`:
        each rank filters its rows with the global draws sliced to them
        (through B1, B4, B5 or B3 on CUDA, as on one device), and the
        estimates are gathered in rank order. ``mesh=None`` turns it off."""
        if mesh is not None:
            from ..parallel.mesh import axis_names

            if axis_name not in axis_names(mesh):
                raise ValueError(f"the data-parallel mesh has axes {axis_names(mesh)} "
                                 f"and no {axis_name!r} axis")
            mesh = (mesh, axis_name)
        self._data_mesh = mesh
        self._loops_run.clear()

    @staticmethod
    def _auto_microbatches(n: int, cap: int = 8) -> int:
        """Largest divisor of n that is <= cap (>= 1)."""
        from ..parallel.data_parallel import auto_microbatches

        return auto_microbatches(n, cap)

    def _layout(self, batch: int):
        """The ``parallel.data_parallel.Layout`` of a loop over `batch`
        trajectories, or None on one device."""
        from ..parallel.data_parallel import Layout
        from ..parallel.mesh import axis_size

        if self._pipeline is not None:
            mesh, axis_name, micro, data_axis, particle_axis = self._pipeline
            if micro is None:
                data_size = axis_size(mesh, data_axis)
                if batch % data_size:
                    raise ValueError(f"eval batch N={batch} does not divide over the "
                                     f"pipeline mesh's {data_size}-way data axis")
                micro = self._auto_microbatches(batch // data_size)
            return Layout(mesh, axis_name, micro, data_axis, particle_axis)
        if self._data_mesh is not None:
            mesh, axis_name = self._data_mesh
            return Layout(mesh, data_axis=axis_name)
        return None

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

    def _gate(self):
        """The crossmodal PF gate's def, or None (no gate, or no measurement
        model)."""
        mm = getattr(self.definition, "measurement_model", None)
        return getattr(mm, "crossmodal_weight_model", None)

    @property
    def know_image_blackout(self) -> bool:
        """The def's own flag (the crossmodal KF), else its PF gate's."""
        if hasattr(self.definition, "know_image_blackout"):
            return self.definition.know_image_blackout
        gate = self._gate()
        return bool(gate is not None and gate.know_image_blackout)

    @know_image_blackout.setter
    def know_image_blackout(self, value: bool):
        """Scripts flip this after construction
        (``scripts/door_task/train_door.py:73``); defs are frozen, so the def
        is rebuilt with the flag. Its networks, and so ``params``, are kept.
        A def with neither the flag nor a gate ignores it, as in JAX."""
        defn, gate = self.definition, self._gate()
        if hasattr(defn, "know_image_blackout"):
            self.definition = dataclasses.replace(defn, know_image_blackout=value)
        elif gate is not None:
            self.definition = dataclasses.replace(
                defn,
                measurement_model=dataclasses.replace(
                    defn.measurement_model, crossmodal_weight_model=dataclasses.replace(
                        gate, know_image_blackout=value)),
            )
        self._loops_run.clear()

    def num_parameters(self) -> int:
        return sum(p.numel() for p in self.params.parameters())

    def loop_cache_key(self, batch: int):
        """The configuration the next ``forward_loop`` over `batch`
        trajectories runs in: (mode, enabled modalities, batch, def, and the
        multi-device layout). The
        JAX facade keys its compiled loops so; here a key first run pays the
        kernels' build and cuDNN's first calls, which the eval's warm-up
        (``crossmodal/_eval_throughput.warm_up_loop``) keeps out of the
        timed run."""
        layout = self._layout(batch)
        if layout is not None:
            from ..parallel.mesh import mesh_fingerprint

            layout = layout._replace(mesh=mesh_fingerprint(layout.mesh))
        return (self._training, self._enabled_tuple, batch, id(self.definition), layout)

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
        with span(SPAN_FACADE_INITIALIZE), torch.no_grad():
            self._belief = self.definition.initialize_beliefs(
                self._to_device(mean), self._to_device(covariance),
                train=self._training, generator=self.generator,
            )

    def measurement_initialize_beliefs(self, observations):
        """The belief from one frame's observations (dict of (N, ...))
        alone: the Kalman filters' virtual sensors, under the enabled
        modalities where the def fuses them."""
        with torch.no_grad():
            self._belief = measurement_initialize(
                self.definition, self._to_device(observations),
                enabled=self._enabled_tuple, train=self._training)

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
        with span(SPAN_FACADE_FORWARD_LOOP):
            self._belief, estimates = self.run_loop(
                self._belief, self._to_device(observations), self._to_device(controls),
                eps_seq=None if eps_seq is None else self._to_device(eps_seq),
                uniforms_seq=None if uniforms_seq is None else self._to_device(uniforms_seq),
                generator=self.generator,
            )
            self._loops_run.add(self.loop_cache_key(estimates.shape[1]))
        return estimates

    def run_loop(self, belief, observations, controls, *, generator,
                 eps_seq=None, uniforms_seq=None):
        """The configured loop from `belief` over device tensors, drawing
        from `generator`: (final belief, estimates (T, N, D)); the stored
        belief is left alone. On a mesh the inputs and outputs are global
        (with a pipeline, T is padded to the stage count, and the noise is
        drawn for the padded T)."""
        layout = self._layout(controls.shape[1])
        train, enabled = self._training, self._enabled_tuple
        if layout is None:
            return self.definition.forward_loop(
                belief, observations, controls, train=train, enabled=enabled,
                eps_seq=eps_seq, uniforms_seq=uniforms_seq, generator=generator)
        from ..parallel.data_parallel import mesh_forward_loop
        from ..parallel.mesh import axis_size

        t = controls.shape[0]
        if layout.pipe_axis is not None:
            observations, controls = pad_time_to_stages(
                observations, controls, axis_size(layout.mesh, layout.pipe_axis))
            if eps_seq is not None and eps_seq.shape[0] != controls.shape[0]:
                raise ValueError("the pre-drawn noise of a pipelined loop covers the "
                                 f"padded time axis ({controls.shape[0]} steps)")
        belief, estimates = mesh_forward_loop(
            self.definition, layout, belief, observations, controls, train=train,
            enabled=enabled, eps_seq=eps_seq, uniforms_seq=uniforms_seq, generator=generator)
        return belief, estimates[:t]

    # -- Kalman filter surface -------------------------------------------------
    @property
    def state_covariance_estimate(self):
        """The fused covariance of a Gaussian belief (the crossmodal KF's,
        or a plain EKF's); None for other beliefs."""
        if isinstance(self._belief, GaussianBelief):
            return self._belief.cov
        return None

    @property
    def weighted_covariances(self):
        return self.state_covariance_estimate


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
