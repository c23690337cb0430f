"""Task networks (port of ``multimodalfilter_tpu/models/task_nets.py``): the
observation encoders, ``DynamicsNet``, ``LogLikelihoodNet`` and
``PFWeightNet`` of the particle filters, ``VirtualSensorNet`` and
``KFWeightNet`` of the Kalman filters, and the LSTM baseline's
``LSTMFilterNet`` with its cell, ``OptimizedLSTMCell``.

Attribute names are the flax scope names, so the state-dict keys of each net
are its flax param paths. Flax infers input widths from data; here they are
arguments (door defaults: state 3, control 7, gripper_pos 3,
gripper_sensors 7).

The observation encoders take the serving options of their def as keyword
arguments of each call, where the flax nets hold them as module fields: a
compute ``dtype`` (the encoders compute in it and their concatenated
features return in fp32, so every trunk after them stays fp32) and
``fold_tail`` (the image encoder's folded tail); see ``encoders.py``. An
observations dict may carry ``"_image_features"``: the image encoder's
output, precomputed by the stacked pass (``stacked.py``), which then stands
in for the net's own image encoder.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from .encoders import ImageEncoder, MLPEncoder
from .resblocks import LinearResblock

MODALITY_ORDER = ("image", "pos", "sensors")


def _check_modalities(modalities) -> Tuple[str, ...]:
    mods = tuple(m for m in MODALITY_ORDER if m in modalities)
    if len(mods) != len(set(modalities)) or not mods:
        raise ValueError(f"Invalid modality set: {modalities}")
    return mods


class _ObservationEncoders(nn.Module):
    """Per-modality encoders, concatenated in the order image, pos, sensors.
    Only the selected modalities get an encoder."""

    def __init__(self, units: int, modalities: Sequence[str] = MODALITY_ORDER,
                 spanning_avg_pool: bool = False, *, pos_dim: int = 3,
                 sensors_dim: int = 7, device=None):
        super().__init__()
        self.modalities = _check_modalities(modalities)
        if "image" in self.modalities:
            self.observation_image_layers = ImageEncoder(units, spanning_avg_pool,
                                                         device=device)
        if "pos" in self.modalities:
            self.observation_pos_layers = MLPEncoder(pos_dim, units, device=device)
        if "sensors" in self.modalities:
            self.observation_sensors_layers = MLPEncoder(
                sensors_dim, units, device=device
            )
        self.out_features = units * len(self.modalities)

    @property
    def image_encoder(self) -> Optional[ImageEncoder]:
        return getattr(self, "observation_image_layers", None)

    def forward(self, observations, *, dtype=None, fold_tail: bool = False) -> torch.Tensor:
        feats = []
        if "image" in self.modalities:
            pre = observations.get("_image_features")
            feats.append(pre if pre is not None else self.observation_image_layers(
                observations["image"], dtype=dtype, fold_tail=fold_tail))
        if "pos" in self.modalities:
            feats.append(self.observation_pos_layers(observations["gripper_pos"],
                                                     dtype=dtype))
        if "sensors" in self.modalities:
            feats.append(self.observation_sensors_layers(observations["gripper_sensors"],
                                                         dtype=dtype))
        out = torch.cat(feats, dim=-1)
        # The features re-enter fp32 math downstream.
        return out if dtype is None else out.float()


class DynamicsNet(nn.Module):
    """Gated residual dynamics: x' = x + dir * sigmoid(gate), with constant
    diagonal process noise sqrt-diag `q_scale_tril_diag`.

    Split into ``encode_controls`` (carry-independent; ``forward_loop``
    hoists it out of the time loop) and ``from_control_features``."""

    def __init__(self, state_dim: int, q_scale_tril_diag: Sequence[float],
                 units: int = 64, control_dim: int = 7, *, device=None):
        super().__init__()
        self.state_dim = state_dim
        self.units = units
        self.q_scale_tril_diag = tuple(float(v) for v in q_scale_tril_diag)
        self.control_layers = MLPEncoder(control_dim, units, device=device)
        self.state_layers = MLPEncoder(state_dim, units, device=device)
        self.shared_dense_in = nn.Linear(2 * units, units, device=device)
        self.shared_resblock0 = LinearResblock(units, device=device)
        self.shared_resblock1 = LinearResblock(units, device=device)
        self.shared_resblock2 = LinearResblock(units, device=device)
        self.shared_dense_out = nn.Linear(units, state_dim + 1, device=device)
        # Fixed process noise: configuration, not a parameter (flax keeps it
        # out of the param tree too), so it stays out of the state dict.
        self.register_buffer(
            "q_scale_tril",
            torch.diag(torch.tensor(q_scale_tril_diag, dtype=torch.float32,
                                    device=device)),
            persistent=False,
        )

    def encode_controls(self, controls):
        """Control features (B, units) — carry-independent (hoistable)."""
        return self.control_layers(controls)

    def from_control_features(self, states, control_features):
        state_features = self.state_layers(states)
        # Reference concat order: (control, state).
        x = torch.cat([control_features, state_features], dim=-1)
        # No activation between the input dense and the first resblock.
        x = self.shared_dense_in(x)
        x = self.shared_resblock0(x)
        x = self.shared_resblock1(x)
        x = self.shared_resblock2(x)
        x = self.shared_dense_out(x)

        direction = x[..., : self.state_dim]
        gate = torch.sigmoid(x[..., -1:])
        states_new = states + direction * gate
        scale_tril = self.q_scale_tril.to(states.dtype).expand(
            states.shape[:-1] + (self.state_dim, self.state_dim)
        )
        return states_new, scale_tril

    def forward(self, states, controls=None, *, control_features=None):
        """states (B, D), controls (B, C) -> (new_states (B, D),
        scale_tril (B, D, D)); or from hoisted `control_features` (B, U)
        in place of the controls."""
        if control_features is None:
            control_features = self.encode_controls(controls)
        return self.from_control_features(states, control_features)


class LogLikelihoodNet(nn.Module):
    """Particle-filter measurement model: per-particle log-likelihoods.

    forward(states (N, M, D), observations) -> (N, M), split into
    ``encode_obs`` (particle-independent; hoisted over all T*N frames) and
    ``from_features`` (the per-particle trunk)."""

    def __init__(self, state_dim: int, modalities: Sequence[str] = MODALITY_ORDER,
                 units: int = 64, spanning_avg_pool: bool = False, *, device=None):
        super().__init__()
        self.state_dim = state_dim
        self.obs_encoders = _ObservationEncoders(units, modalities, spanning_avg_pool,
                                                 device=device)
        self.state_layers = MLPEncoder(state_dim, units, device=device)
        self.shared_dense_in = nn.Linear(
            self.obs_encoders.out_features + units, units, device=device
        )
        self.shared_resblock0 = LinearResblock(units, device=device)
        self.shared_resblock1 = LinearResblock(units, device=device)
        self.shared_dense_out = nn.Linear(units, 1, device=device)

    def encode_obs(self, observations, *, dtype=None, fold_tail: bool = False):
        """(N, ...) observations -> (N, units * num_modalities) fp32 features."""
        return self.obs_encoders(observations, dtype=dtype, fold_tail=fold_tail)

    def from_features(self, states, obs_features) -> torch.Tensor:
        """states (N, M, D) + obs features (N, F) -> log-likelihoods (N, M)."""
        n, m, d = states.shape
        if d != self.state_dim:
            raise ValueError(f"state dim {d} != {self.state_dim}")
        obs_features = obs_features[:, None, :].expand(n, m, obs_features.shape[-1])
        state_features = self.state_layers(states)
        # Concat order: (obs, state).
        x = torch.cat([obs_features, state_features], dim=-1)
        x = torch.relu(self.shared_dense_in(x))
        x = self.shared_resblock0(x)
        x = self.shared_resblock1(x)
        return self.shared_dense_out(x).squeeze(-1)

    def forward(self, states, observations, *, dtype=None, fold_tail: bool = False):
        return self.from_features(
            states, self.encode_obs(observations, dtype=dtype, fold_tail=fold_tail))


class PFWeightNet(nn.Module):
    """Crossmodal PF gate: observations -> per-modality log-weights (N, K).
    The door gate has 3 fusion resblocks."""

    def __init__(self, modality_count: int = 2, units: int = 64,
                 num_fusion_resblocks: int = 3, *, device=None):
        super().__init__()
        self.obs_encoders = _ObservationEncoders(units, MODALITY_ORDER, device=device)
        self.fusion_dense_in = nn.Linear(
            self.obs_encoders.out_features, units, device=device
        )
        self.num_fusion_resblocks = num_fusion_resblocks
        for i in range(num_fusion_resblocks):
            self.add_module(f"fusion_resblock{i}", LinearResblock(units, device=device))
        self.fusion_dense_out = nn.Linear(units, modality_count, device=device)

    def forward(self, observations, *, dtype=None, fold_tail: bool = False):
        x = self.obs_encoders(observations, dtype=dtype, fold_tail=fold_tail)
        x = torch.relu(self.fusion_dense_in(x))
        for i in range(self.num_fusion_resblocks):
            x = getattr(self, f"fusion_resblock{i}")(x)
        return self.fusion_dense_out(x)


class VirtualSensorNet(nn.Module):
    """Virtual sensor: observations -> (predicted state z (N, D), diagonal
    scale_tril (N, D, D)).

    A shared trunk of width 2*units splits into the z head (first half) and
    the r head (second half); cov = diag(lt_hat)^2 + add_R_noise * I, and
    the scale_tril is its square root. With ``noise_R_tril_diag`` the r head
    is absent and lt_hat is that constant."""

    def __init__(self, state_dim: int, modalities: Sequence[str] = MODALITY_ORDER,
                 units: int = 64, add_R_noise: float = 1e-6,
                 spanning_avg_pool: bool = False,
                 noise_R_tril_diag: Optional[Sequence[float]] = None, *, device=None):
        super().__init__()
        self.state_dim = state_dim
        self.units = units
        self.add_R_noise = add_R_noise
        self.obs_encoders = _ObservationEncoders(units, modalities, spanning_avg_pool,
                                                 device=device)
        self.shared_dense_in = nn.Linear(self.obs_encoders.out_features, 2 * units,
                                         device=device)
        self.shared_resblock0 = LinearResblock(2 * units, device=device)
        self.shared_resblock1 = LinearResblock(2 * units, device=device)
        heads = ("z_layer",) if noise_R_tril_diag is not None else ("z_layer", "r_layer")
        for head in heads:
            self.add_module(f"{head}_dense_in", nn.Linear(units, state_dim, device=device))
            self.add_module(f"{head}_resblock", LinearResblock(state_dim, device=device))
            self.add_module(f"{head}_dense_out",
                            nn.Linear(state_dim, state_dim, device=device))
        self.register_buffer(
            "noise_R_tril_diag",
            None if noise_R_tril_diag is None else torch.tensor(
                noise_R_tril_diag, dtype=torch.float32, device=device),
            persistent=False,
        )

    def _head(self, name: str, x):
        x = torch.relu(getattr(self, f"{name}_dense_in")(x))
        x = getattr(self, f"{name}_resblock")(x)
        return getattr(self, f"{name}_dense_out")(x)

    def forward(self, observations, *, dtype=None, fold_tail: bool = False):
        x = self.obs_encoders(observations, dtype=dtype, fold_tail=fold_tail)
        x = torch.relu(self.shared_dense_in(x))
        x = self.shared_resblock1(self.shared_resblock0(x))
        z = self._head("z_layer", x[:, : self.units])
        if self.noise_R_tril_diag is None:
            lt_hat = self._head("r_layer", x[:, self.units:])
        else:
            lt_hat = self.noise_R_tril_diag.to(x.dtype).expand(x.shape[0], self.state_dim)
        scale_tril = torch.diag_embed(torch.sqrt(lt_hat ** 2 + self.add_R_noise))
        return z, scale_tril


class KFWeightNet(nn.Module):
    """Crossmodal KF gate: observations -> per-state-dim weights
    (modality_count, N, state_dim), normalised over the modalities.

    ``weighting_type`` is "sigmoid" (the reference's), "softmax" or
    "absolute". ``reference_reshape=False`` (the default) takes the gate
    output (N, K*D) to (K, N, D) through (N, K, D), so a row's weights are
    its own; True reshapes it row-major straight to (K, N, D), as the
    reference does, which mixes weights across the batch (to reproduce a
    reference checkpoint's outputs at N > 1)."""

    WEIGHTING_TYPES = ("sigmoid", "softmax", "absolute")

    def __init__(self, state_dim: int, modality_count: int = 2, units: int = 64,
                 weighting_type: str = "sigmoid", reference_reshape: bool = False, *,
                 device=None):
        super().__init__()
        if weighting_type not in self.WEIGHTING_TYPES:
            raise ValueError(f"weighting_type {weighting_type!r} not in "
                             f"{self.WEIGHTING_TYPES}")
        self.state_dim = state_dim
        self.modality_count = modality_count
        self.weighting_type = weighting_type
        self.reference_reshape = reference_reshape
        self.obs_encoders = _ObservationEncoders(units, MODALITY_ORDER, device=device)
        self.fusion_dense_in = nn.Linear(self.obs_encoders.out_features, units,
                                         device=device)
        self.fusion_resblock0 = LinearResblock(units, device=device)
        self.fusion_dense_out = nn.Linear(units, modality_count * state_dim, device=device)

    def forward(self, observations, *, dtype=None, fold_tail: bool = False):
        x = self.obs_encoders(observations, dtype=dtype, fold_tail=fold_tail)
        x = torch.relu(self.fusion_dense_in(x))
        x = self.fusion_dense_out(self.fusion_resblock0(x))
        if self.weighting_type == "sigmoid":
            x = torch.sigmoid(x)
        n, k, d = x.shape[0], self.modality_count, self.state_dim
        if self.reference_reshape:
            weights = x.reshape(k, n, d)
        else:
            weights = x.reshape(n, k, d).transpose(0, 1)
        if self.weighting_type == "absolute":
            weights = weights.abs()
        elif self.weighting_type == "softmax":
            weights = torch.softmax(weights, dim=0)
        return weights / (weights.sum(dim=0) + 1e-9)


class OptimizedLSTMCell(nn.Module):
    """flax's ``nn.OptimizedLSTMCell``, with its parameters: per gate
    (i, f, g, o) an input dense ``i<gate>`` (no bias) and a recurrent dense
    ``h<gate>`` (with the bias), so the state-dict keys are flax's
    (``ii.weight``, ``hi.weight``, ``hi.bias``, ...; ``if`` is a keyword, so
    the denses are registered by name). The carry is (c, h), flax's order,
    not ``torch.nn.LSTMCell``'s (h, c):

        i, f, o = sigmoid(.), g = tanh(.)
        c' = f c + i g,  h' = o tanh(c')

    The eight denses run as one (in + H, 4H) product (``packed``), which a
    loop builds once and passes to every step."""

    GATES = ("i", "f", "g", "o")
    # The kernels flax draws with its recurrent_kernel_init (orthogonal);
    # weights.init_params reads this.
    recurrent_kernels = tuple(f"h{gate}" for gate in GATES)

    def __init__(self, in_features: int, hidden: int, *, device=None):
        super().__init__()
        self.hidden = hidden
        for gate in self.GATES:
            self.add_module(f"i{gate}", nn.Linear(in_features, hidden, bias=False,
                                                  device=device))
            self.add_module(f"h{gate}", nn.Linear(hidden, hidden, device=device))

    def packed(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(weight (4H, in + H), bias (4H,)): gate-major rows, each the input
        kernel's columns then the recurrent kernel's."""
        weight = torch.cat([
            torch.cat([getattr(self, f"i{g}").weight, getattr(self, f"h{g}").weight], dim=1)
            for g in self.GATES
        ])
        bias = torch.cat([getattr(self, f"h{g}").bias for g in self.GATES])
        return weight, bias

    def forward(self, carry, x, packed=None):
        """carry (c, h), each (N, H); x (N, in) -> ((c', h'), h')."""
        c, h = carry
        weight, bias = self.packed() if packed is None else packed
        y = torch.addmm(bias, torch.cat([x, h], dim=-1), weight.t())
        i, f, g, o = y.chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        return (c, h), h


class LSTMFilterNet(nn.Module):
    """LSTM baseline: the observation encoders (all modalities) and a
    control encoder, fused (dense, ReLU, resblock), a stack of LSTM cells
    (hidden 512), and a head to the state (dense, ReLU, dense).

    ``encode`` runs on any number of frames (the filter encodes all T*N at
    once); ``lstm_step`` advances the cells by one step."""

    def __init__(self, state_dim: int, units: int = 64, lstm_hidden_dim: int = 512,
                 lstm_num_layers: int = 2, control_dim: int = 7,
                 spanning_avg_pool: bool = False, *, device=None):
        super().__init__()
        self.lstm_hidden_dim = lstm_hidden_dim
        self.lstm_num_layers = lstm_num_layers
        self.obs_encoders = _ObservationEncoders(units, MODALITY_ORDER, spanning_avg_pool,
                                                 device=device)
        self.control_layers = MLPEncoder(control_dim, units, device=device)
        self.fusion_dense = nn.Linear(self.obs_encoders.out_features + units, units,
                                      device=device)
        self.fusion_resblock = LinearResblock(units, device=device)
        for i in range(lstm_num_layers):
            self.add_module(f"lstm_{i}", OptimizedLSTMCell(
                units if i == 0 else lstm_hidden_dim, lstm_hidden_dim, device=device))
        self.output_dense_in = nn.Linear(lstm_hidden_dim, units, device=device)
        self.output_dense_out = nn.Linear(units, state_dim, device=device)

    @property
    def cells(self) -> Tuple[OptimizedLSTMCell, ...]:
        return tuple(getattr(self, f"lstm_{i}") for i in range(self.lstm_num_layers))

    def encode(self, observations, controls, *, fold_tail: bool = False) -> torch.Tensor:
        """Fused features (B, units) of B frames. The LSTM takes the folded
        tail but no compute dtype, as in the JAX package."""
        merged = torch.cat([self.obs_encoders(observations, fold_tail=fold_tail),
                            self.control_layers(controls)], dim=-1)
        return self.fusion_resblock(torch.relu(self.fusion_dense(merged)))

    def packed_cells(self):
        """Each cell's ``packed`` weights, for a loop of ``lstm_step``s."""
        return tuple(cell.packed() for cell in self.cells)

    def lstm_step(self, carry, features, packed=None):
        """carry: one (c, h) a layer; features (N, units) -> (carry',
        state (N, state_dim))."""
        packed = self.packed_cells() if packed is None else packed
        new_carry, x = [], features
        for cell, layer_carry, weights in zip(self.cells, carry, packed):
            layer_carry, x = cell(layer_carry, x, weights)
            new_carry.append(layer_carry)
        state = self.output_dense_out(torch.relu(self.output_dense_in(x)))
        return tuple(new_carry), state

    def forward(self, observations, controls, carry, *, fold_tail: bool = False):
        """One filter step."""
        return self.lstm_step(carry, self.encode(observations, controls,
                                                 fold_tail=fold_tail))
