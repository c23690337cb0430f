"""Plain fp32 reference of the crossmodal particle filters' networks.

Written from the published description (Lee et al., "Multimodal Sensor
Fusion with Differentiable Filters", IROS 2020; brentyi/multimodalfilter
``crossmodal/{door,push}_models``), in plain ``torch`` operations on a flat
dict of named tensors. It imports nothing of the program: the names are the
parameter layout a configuration file implies (``param_spec``), and loading
that dict into the program with ``strict=True`` is what ties the two.

  MLP encoder:   Dense(U) -> ReLU -> resblock(U)
  Image encoder: Conv5x5(32) -> ReLU -> conv resblock(32) -> Conv3x3(16)
                 -> ReLU -> Conv3x3(8) -> flatten (c, h, w) -> Dense(U)
                 -> ReLU -> resblock(U)
  resblock:      x + ReLU(W2 ReLU(W1 x))
  Dynamics:      x' = x + dir * sigmoid(gate), (dir, gate) = trunk(ctrl, x)
  Likelihood:    ll = trunk(obs features, x), one per modality model
  Gate:          log-weights (K,) of the modality models from all modalities
  Fusion:        logsumexp_k(gate_k + ll_k)

The dense_in layers of the dynamics and likelihood trunks act on a
concatenation of a per-frame half (controls, observations) and a
per-particle half (the state); the reference applies each half's columns
separately, the per-frame half once a frame. That is the same linear map
(summed in another order) and the least work the shapes need, which is
what ``portbench/counts`` counts.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

MODALITY_ORDER = ("image", "pos", "sensors")
OBS_KEYS = {"image": "image", "pos": "gripper_pos", "sensors": "gripper_sensors"}
IMAGE_CONVS = (("conv1", 1, 32, 5), ("resblock_conv.block1", 32, 32, 3),
               ("resblock_conv.block2", 32, 32, 3), ("conv2", 32, 16, 3),
               ("conv3", 16, 8, 3))


def _dense_spec(name: str, n_in: int, n_out: int) -> List[Tuple[str, tuple]]:
    return [(f"{name}.weight", (n_out, n_in)), (f"{name}.bias", (n_out,))]


def _resblock_spec(name: str, units: int):
    return _dense_spec(f"{name}.block1", units, units) + _dense_spec(f"{name}.block2", units, units)


def _mlp_spec(name: str, n_in: int, units: int):
    return _dense_spec(f"{name}.dense", n_in, units) + _resblock_spec(f"{name}.resblock", units)


def _image_spec(name: str, cfg) -> list:
    units, side = cfg["units"], cfg["image_size"]
    spec = []
    for conv, c_in, c_out, k in IMAGE_CONVS:
        spec += [(f"{name}.{conv}.weight", (c_out, c_in, k, k)), (f"{name}.{conv}.bias", (c_out,))]
    spec += _dense_spec(f"{name}.dense", IMAGE_CONVS[-1][2] * side * side, units)
    return spec + _resblock_spec(f"{name}.resblock", units)


def _obs_dims(cfg) -> Dict[str, int]:
    return {"pos": cfg["pos_dim"], "sensors": cfg["sensors_dim"]}


def _encoders_spec(prefix: str, modalities, cfg) -> list:
    spec = []
    for mod in MODALITY_ORDER:
        if mod not in modalities:
            continue
        name = f"{prefix}.obs_encoders.observation_{mod}_layers"
        spec += (_image_spec(name, cfg) if mod == "image"
                 else _mlp_spec(name, _obs_dims(cfg)[mod], cfg["units"]))
    return spec


def param_spec(cfg) -> List[Tuple[str, tuple]]:
    """(name, shape) of every parameter of a crossmodal PF configuration,
    in a fixed order: the dynamics, each modality model, the gate."""
    u, d = cfg["units"], cfg["state_dim"]
    dyn = "dynamics_model"
    spec = (_mlp_spec(f"{dyn}.control_layers", cfg["control_dim"], u)
            + _mlp_spec(f"{dyn}.state_layers", d, u)
            + _dense_spec(f"{dyn}.shared_dense_in", 2 * u, u))
    for r in range(3):
        spec += _resblock_spec(f"{dyn}.shared_resblock{r}", u)
    spec += _dense_spec(f"{dyn}.shared_dense_out", u, d + 1)
    for k, mods in enumerate(cfg["measurement_modalities"]):
        mm = f"measurement_model.measurement_models.{k}"
        spec += _encoders_spec(mm, mods, cfg)
        spec += _mlp_spec(f"{mm}.state_layers", d, u)
        spec += _dense_spec(f"{mm}.shared_dense_in", u * len(mods) + u, u)
        spec += _resblock_spec(f"{mm}.shared_resblock0", u)
        spec += _resblock_spec(f"{mm}.shared_resblock1", u)
        spec += _dense_spec(f"{mm}.shared_dense_out", u, 1)
    gate = "measurement_model.crossmodal_weight_model"
    spec += _encoders_spec(gate, MODALITY_ORDER, cfg)
    spec += _dense_spec(f"{gate}.fusion_dense_in", u * len(MODALITY_ORDER), u)
    for r in range(cfg["gate_fusion_resblocks"]):
        spec += _resblock_spec(f"{gate}.fusion_resblock{r}", u)
    spec += _dense_spec(f"{gate}.fusion_dense_out", u, len(cfg["measurement_modalities"]))
    return spec


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------


def dense(w, name: str, x):
    return x @ w[f"{name}.weight"].T + w[f"{name}.bias"]


def resblock(w, name: str, x):
    h = torch.relu(dense(w, f"{name}.block1", x))
    return x + torch.relu(dense(w, f"{name}.block2", h))


def mlp(w, name: str, x):
    return resblock(w, f"{name}.resblock", torch.relu(dense(w, f"{name}.dense", x)))


def _conv(w, name: str, x):
    weight = w[f"{name}.weight"]
    return F.conv2d(x, weight, w[f"{name}.bias"], padding=weight.shape[-1] // 2)


def image_encoder(w, name: str, images):
    """images (B, S, S) -> (B, U)."""
    x = torch.relu(_conv(w, f"{name}.conv1", images[:, None]))
    h = torch.relu(_conv(w, f"{name}.resblock_conv.block1", x))
    x = x + torch.relu(_conv(w, f"{name}.resblock_conv.block2", h))
    x = torch.relu(_conv(w, f"{name}.conv2", x))
    x = _conv(w, f"{name}.conv3", x).flatten(1)
    return resblock(w, f"{name}.resblock", torch.relu(dense(w, f"{name}.dense", x)))


def observation_features(w, prefix: str, modalities, obs):
    """Frames (B, ...) of each modality -> (B, U * len(modalities)), in the
    order image, pos, sensors."""
    feats = []
    for mod in MODALITY_ORDER:
        if mod not in modalities:
            continue
        name = f"{prefix}.obs_encoders.observation_{mod}_layers"
        x = obs[OBS_KEYS[mod]]
        feats.append(image_encoder(w, name, x) if mod == "image" else mlp(w, name, x))
    return torch.cat(feats, dim=-1)


# ---------------------------------------------------------------------------
# The filter's per-frame and per-particle parts
# ---------------------------------------------------------------------------


def frame_terms(w, cfg, obs, controls):
    """Everything that depends on a frame alone, over B frames: the
    dynamics trunk's control half of dense_in (B, U), each modality model's
    observation half (K, B, U) and the gate's log-weights (B, K)."""
    u = cfg["units"]
    dyn = "dynamics_model"
    ctrl = mlp(w, f"{dyn}.control_layers", controls)
    w_in = w[f"{dyn}.shared_dense_in.weight"]
    dyn_row = ctrl @ w_in[:, :u].T + w[f"{dyn}.shared_dense_in.bias"]
    mm_rows = []
    for k, mods in enumerate(cfg["measurement_modalities"]):
        mm = f"measurement_model.measurement_models.{k}"
        f = observation_features(w, mm, mods, obs)
        w_mm = w[f"{mm}.shared_dense_in.weight"]
        mm_rows.append(f @ w_mm[:, :f.shape[1]].T + w[f"{mm}.shared_dense_in.bias"])
    gate = "measurement_model.crossmodal_weight_model"
    g = torch.relu(dense(w, f"{gate}.fusion_dense_in",
                         observation_features(w, gate, MODALITY_ORDER, obs)))
    for r in range(cfg["gate_fusion_resblocks"]):
        g = resblock(w, f"{gate}.fusion_resblock{r}", g)
    return dyn_row, torch.stack(mm_rows), dense(w, f"{gate}.fusion_dense_out", g)


def propagate(w, cfg, x, dyn_row):
    """Mean of the dynamics: x (P, D), dyn_row (P, U) -> (P, D)."""
    u, d = cfg["units"], cfg["state_dim"]
    dyn = "dynamics_model"
    s = mlp(w, f"{dyn}.state_layers", x)
    z = dyn_row + s @ w[f"{dyn}.shared_dense_in.weight"][:, u:].T  # no activation
    for r in range(3):
        z = resblock(w, f"{dyn}.shared_resblock{r}", z)
    o = dense(w, f"{dyn}.shared_dense_out", z)
    return x + o[:, :d] * torch.sigmoid(o[:, d:])


def log_likelihoods(w, cfg, x, mm_rows, gate):
    """Fused log-likelihoods (P,) of particles x (P, D) given each modality
    model's per-frame row (K, P, U) and the gate (P, K)."""
    u = cfg["units"]
    lls = []
    for k in range(len(cfg["measurement_modalities"])):
        mm = f"measurement_model.measurement_models.{k}"
        s = mlp(w, f"{mm}.state_layers", x)
        w_in = w[f"{mm}.shared_dense_in.weight"]
        z = torch.relu(mm_rows[k] + s @ w_in[:, w_in.shape[1] - u:].T)
        z = resblock(w, f"{mm}.shared_resblock1", resblock(w, f"{mm}.shared_resblock0", z))
        lls.append(dense(w, f"{mm}.shared_dense_out", z)[:, 0] + gate[:, k])
    return torch.logsumexp(torch.stack(lls, dim=-1), dim=-1)
