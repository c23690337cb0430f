"""Import trained reference (PyTorch) checkpoints (port of
``multimodalfilter_tpu/experiments/torch_import.py``).

The reference trains torch models whose container paths the port's module
tree mirrors (``dynamics_model``, ``measurement_model.measurement_models.0``,
``filter_models.1.virtual_sensor_model``, ...), and both are torch: a Linear
weight is (out, in) on both sides, a Conv2d weight OIHW, and both flatten the
image encoder's activation in NCHW order (the push task's spanning pools
included). So the import maps paths and copies tensors unchanged:

  - the reference's ``nn.Sequential`` indices become the port's named
    submodules (the per-architecture index maps below encode the reference's
    layer stacks, e.g. crossmodal/door_models/dynamics.py:26-34, pf.py:43-59,
    kf.py:49-78);
  - the observation encoders, at the top of a reference net, sit under the
    port net's ``obs_encoders``;
  - fannypack resblock children are detected by name (two children with a
    weight, ordered by name: block1 before block2 upstream).

Semantics caveat (crossmodal-KF gate): the reference's weight model reshapes
its (N, K*state_dim) gate output row-major to (K, N, state_dim)
(crossmodal/door_models/crossmodal_kf.py:158 of the reference), which mixes
weights across batch elements. The port, as the JAX package, takes the
batch-independent reshape (``models/task_nets.py:KFWeightNet``), so an
imported reference crossmodal-KF checkpoint reproduces the reference's
outputs only at batch size N=1. For outputs faithful to the reference at
N>1, switch the gate net's flag after the import:

    model.crossmodal_weight_model.params.reference_reshape = True

Usage:
    state = convert_filter_state_dict(reference_state_dict, model.definition)
    model.params.load_state_dict(state)
or through ``Buddy.load_torch_checkpoint(path)``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch

StateDict = Dict[str, torch.Tensor]


def _subtree(state_dict: StateDict, prefix: str) -> StateDict:
    """All keys under a dotted prefix, with the prefix stripped."""
    out = {k[len(prefix) + 1:]: v for k, v in state_dict.items()
           if k.startswith(prefix + ".")}
    if not out:
        raise KeyError(f"No torch parameters under prefix {prefix!r}")
    return out


def _layer(sub: StateDict, ref: str, ours: str) -> StateDict:
    """A Linear or Conv2d: weight and bias, as float32 tensors on the CPU."""
    return {f"{ours}.{name}": sub[f"{ref}.{name}"].detach().to("cpu", torch.float32)
            for name in ("weight", "bias")}


def _resblock(sub: StateDict, ref: str, ours: str) -> StateDict:
    children = sorted({k[len(ref) + 1:].rsplit(".", 1)[0] for k in sub
                       if k.startswith(ref + ".") and k.endswith(".weight")})
    if len(children) != 2:
        raise KeyError(f"expected 2 linear/conv children under resblock {ref!r}, "
                       f"found {children}")
    return {**_layer(sub, f"{ref}.{children[0]}", f"{ours}.block1"),
            **_layer(sub, f"{ref}.{children[1]}", f"{ours}.block2")}


def _mlp_encoder(sub: StateDict, ref: str, ours: str) -> StateDict:
    """Reference: Sequential(Linear, ReLU, resblock), layers.py:20-24."""
    return {**_layer(sub, f"{ref}.0", f"{ours}.dense"),
            **_resblock(sub, f"{ref}.2", f"{ours}.resblock")}


def _image_encoder(sub: StateDict, ref: str, ours: str) -> StateDict:
    """Reference image stacks (door layers.py:52-63; push layers.py:77-104),
    both variants at indices 0, 2, 3, 5, 7, 9: [Conv5x5(32), ReLU,
    ConvRes(32), Conv3x3(16), ReLU, Conv3x3(8 or 2), Flatten or
    DualSpanningAvgPool, Linear, ReLU, resblock]."""
    return {**_layer(sub, f"{ref}.0", f"{ours}.conv1"),
            **_resblock(sub, f"{ref}.2", f"{ours}.resblock_conv"),
            **_layer(sub, f"{ref}.3", f"{ours}.conv2"),
            **_layer(sub, f"{ref}.5", f"{ours}.conv3"),
            **_layer(sub, f"{ref}.7", f"{ours}.dense"),
            **_resblock(sub, f"{ref}.9", f"{ours}.resblock")}


def _obs_encoders(sub: StateDict, encoders) -> StateDict:
    out = {}
    for modality, build in (("image", _image_encoder), ("pos", _mlp_encoder),
                            ("sensors", _mlp_encoder)):
        if modality in encoders.modalities:
            name = f"observation_{modality}_layers"
            out.update(build(sub, name, f"obs_encoders.{name}"))
    return out


# ---------------------------------------------------------------------------
# Per-net converters (reference Sequential index maps in docstrings)
# ---------------------------------------------------------------------------


def convert_dynamics(sub: StateDict) -> StateDict:
    """DynamicsNet <- reference dynamics.py:26-34:
    shared_layers = Sequential(Linear, res, res, res, Linear): 0..4."""
    return {**_mlp_encoder(sub, "state_layers", "state_layers"),
            **_mlp_encoder(sub, "control_layers", "control_layers"),
            **_layer(sub, "shared_layers.0", "shared_dense_in"),
            **{k: v for r in range(3)
               for k, v in _resblock(sub, f"shared_layers.{r + 1}",
                                     f"shared_resblock{r}").items()},
            **_layer(sub, "shared_layers.4", "shared_dense_out")}


def convert_measurement(sub: StateDict, net) -> StateDict:
    """LogLikelihoodNet <- reference pf.py:43-59:
    shared_layers = Sequential(Linear, ReLU, res, res, Linear): 0, 2, 3, 4."""
    return {**_obs_encoders(sub, net.obs_encoders),
            **_mlp_encoder(sub, "state_layers", "state_layers"),
            **_layer(sub, "shared_layers.0", "shared_dense_in"),
            **_resblock(sub, "shared_layers.2", "shared_resblock0"),
            **_resblock(sub, "shared_layers.3", "shared_resblock1"),
            **_layer(sub, "shared_layers.4", "shared_dense_out")}


def convert_virtual_sensor(sub: StateDict, net) -> StateDict:
    """VirtualSensorNet <- reference kf.py:56-76:
    shared = Sequential(Linear, ReLU, res, res): 0, 2, 3;
    z/r heads = Sequential(Linear, ReLU, res, Linear): 0, 2, 3 (the r head
    where the net learns R)."""
    out = {**_obs_encoders(sub, net.obs_encoders),
           **_layer(sub, "shared_layers.0", "shared_dense_in"),
           **_resblock(sub, "shared_layers.2", "shared_resblock0"),
           **_resblock(sub, "shared_layers.3", "shared_resblock1")}
    for head in ("z_layer", "r_layer"):
        if hasattr(net, f"{head}_dense_in"):
            out.update({**_layer(sub, f"{head}.0", f"{head}_dense_in"),
                        **_resblock(sub, f"{head}.2", f"{head}_resblock"),
                        **_layer(sub, f"{head}.3", f"{head}_dense_out")})
    return out


def convert_kf_weight(sub: StateDict, net) -> StateDict:
    """KFWeightNet <- reference crossmodal_kf.py:117-123:
    fusion = Sequential(Linear, ReLU, res, Linear, Sigmoid): 0, 2, 3."""
    return {**_obs_encoders(sub, net.obs_encoders),
            **_layer(sub, "fusion_layers.0", "fusion_dense_in"),
            **_resblock(sub, "fusion_layers.2", "fusion_resblock0"),
            **_layer(sub, "fusion_layers.3", "fusion_dense_out")}


def convert_pf_weight(sub: StateDict, net) -> StateDict:
    """PFWeightNet <- reference door crossmodal_pf.py:64-72 (3 resblocks) /
    push crossmodal_pf.py (1 resblock): fusion indices 0, 2..(2+n-1), 2+n."""
    n = net.num_fusion_resblocks
    out = {**_obs_encoders(sub, net.obs_encoders),
           **_layer(sub, "fusion_layers.0", "fusion_dense_in"),
           **_layer(sub, f"fusion_layers.{2 + n}", "fusion_dense_out")}
    for i in range(n):
        out.update(_resblock(sub, f"fusion_layers.{2 + i}", f"fusion_resblock{i}"))
    return out


# ---------------------------------------------------------------------------
# Def-tree walker
# ---------------------------------------------------------------------------


def _convert_leaf(defn, sub: StateDict):
    from ..filtering.base import DynamicsDef, MeasurementDef, VirtualSensorDef
    from ..filtering.fusion import KFWeightDef, PFWeightDef

    if isinstance(defn, DynamicsDef):
        return convert_dynamics(sub)
    if isinstance(defn, MeasurementDef):
        return convert_measurement(sub, defn.net)
    if isinstance(defn, VirtualSensorDef):
        return convert_virtual_sensor(sub, defn.net)
    if isinstance(defn, KFWeightDef):
        return convert_kf_weight(sub, defn.net)
    if isinstance(defn, PFWeightDef):
        return convert_pf_weight(sub, defn.net)
    return None


_CONTAINER_FIELDS = (
    "dynamics_model",
    "measurement_model",
    "virtual_sensor_model",
    "crossmodal_weight_model",
    "filter_models",
    "measurement_models",
)


def convert_filter_state_dict(state_dict, definition) -> StateDict:
    """A reference torch state dict -> the state dict of
    ``definition.module()`` (the port's parameter paths), walking the
    shared container paths."""

    def walk(defn, prefix: str) -> StateDict:
        sub = _subtree(state_dict, prefix) if prefix else dict(state_dict)
        leaf = _convert_leaf(defn, sub)
        if leaf is not None:
            return leaf
        out = {}
        for field in dataclasses.fields(defn):
            value = getattr(defn, field.name)
            if field.name not in _CONTAINER_FIELDS or value is None:
                continue
            children = enumerate(value) if isinstance(value, tuple) else [(None, value)]
            for i, child in children:
                path = field.name if i is None else f"{field.name}.{i}"
                child_prefix = f"{prefix}.{path}" if prefix else path
                out.update({f"{path}.{k}": v for k, v in walk(child, child_prefix).items()})
        if not out:
            raise KeyError(f"No convertible components in {type(defn).__name__}")
        return out

    return walk(definition, "")


def load_reference_checkpoint(path: str, definition) -> StateDict:
    """Load a reference (fannypack) torch checkpoint file and convert it.
    The file is the reference's own pickle, read with ``weights_only=False``:
    load only checkpoints from a source you trust."""
    blob = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(blob, dict) and "state_dict" in blob:
        blob = blob["state_dict"]
    return convert_filter_state_dict(blob, definition)
