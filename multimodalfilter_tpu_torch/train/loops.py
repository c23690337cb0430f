"""Training loops (port of ``multimodalfilter_tpu/train/loops.py``).

- The dataset is pushed to the device once; each step gathers its batch
  there with an index row. Batch order comes from
  ``np.random.default_rng(buddy.optimizer_steps + 1)``, as in the JAX
  package, so both frameworks see the same batches.
- Each step runs the loss and its backward under ``torch.enable_grad()``,
  whatever the caller's grad mode, then ``optim.apply_gradients``: every
  parameter gets a gradient (zeros where none reached it), frozen paths'
  gradients are zeroed, Adam steps.
- Every random number a loop needs per batch comes from ``draw_noise``.
- The JAX package strips serving-only transforms (folded encoder tail,
  stacked encoders, bf16 compute) from a def before training; the port has
  none of them, so there is nothing to strip.

Losses:
  dynamics single-step / recurrent: MSE of predicted vs true next states
  measurement pretraining:          MSE of predicted vs Gaussian log-density
  e2e filter:                       MSE of filter estimates vs true states
                                    (beliefs initialised at the true first
                                    state with initial_cov_scale * I)
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .optim import apply_gradients, get_named_optimizer


def draw_noise(generator: torch.Generator, shapes, device):
    """Standard-normal tensors of `shapes`, drawn in order from `generator`:
    all the per-batch noise of the train loops (the initial belief's eps and
    the filter's eps_seq in e2e training, the perturbations in measurement
    pretraining)."""
    return tuple(torch.randn(tuple(s), generator=generator, device=device)
                 for s in shapes)


def _model_parts(model):
    """(root filter, sub def) of a filter or a handle. The port's defs own
    their networks, so the sub def needs no param path."""
    return getattr(model, "root", model), model.definition


def _to_device(x, device):
    if isinstance(x, dict):
        return {k: _to_device(v, device) for k, v in x.items()}
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def _gather(tree, idx):
    if isinstance(tree, dict):
        return {k: _gather(v, idx) for k, v in tree.items()}
    return tree[idx]


def _epoch_index_matrix(rng: np.random.Generator, n: int, batch_size: int):
    """(num_batches, batch_size) shuffled indices; the last partial batch is
    dropped."""
    perm = rng.permutation(n)
    num_batches = n // batch_size
    if num_batches == 0:
        raise ValueError(f"dataset ({n}) smaller than batch size ({batch_size})")
    return perm[: num_batches * batch_size].reshape(num_batches, batch_size)


def _make_step(buddy, root, loss_fn, optimizer_name):
    """fn(batch) -> detached loss: one optimizer step of the named Adam over
    all of the root filter's parameters."""
    optimizer = get_named_optimizer(buddy, optimizer_name, root.params)
    frozen = frozenset(root.frozen_paths)

    def step(batch):
        optimizer.zero_grad(set_to_none=True)
        with torch.enable_grad():
            loss = loss_fn(batch)
            loss.backward()
        apply_gradients(optimizer, root.params, frozen)
        return loss.detach()

    return step


def _run_epochs(buddy, root, step, data, n, *, epochs, batch_size, loss_name):
    rng = np.random.default_rng(buddy.optimizer_steps + 1)
    last_loss = None
    for _ in range(epochs):
        idx_matrix = torch.as_tensor(_epoch_index_matrix(rng, n, batch_size),
                                     device=root.device)
        losses = torch.stack([step(_gather(data, idx)) for idx in idx_matrix])
        buddy.increment_steps(int(idx_matrix.shape[0]))
        last_loss = float(losses.mean())
        buddy.log_scalar(f"train/{loss_name}", last_loss)
    return last_loss


def _time_major(x):
    """(B, L, ...) -> (L, B, ...), over a tensor or a dict of tensors."""
    if isinstance(x, dict):
        return {k: v.transpose(0, 1) for k, v in x.items()}
    return x.transpose(0, 1)


# ---------------------------------------------------------------------------
# Dynamics
# ---------------------------------------------------------------------------


def train_dynamics_single_step(
    buddy, model, dataset, *, epochs, batch_size=32,
    optimizer_name="train_dynamics_single_step",
):
    root, defn = _model_parts(model)
    dyn = defn.dynamics_model

    def loss_fn(batch):
        pred, _ = dyn.apply(batch["prev"], batch["controls"])
        return torch.mean((pred - batch["next"]) ** 2)

    data = _to_device({"prev": dataset.previous_states, "next": dataset.states,
                       "controls": dataset.controls}, root.device)
    step = _make_step(buddy, root, loss_fn, optimizer_name)
    return _run_epochs(buddy, root, step, data, len(dataset), epochs=epochs,
                       batch_size=batch_size, loss_name="dynamics_single_step")


def train_dynamics_recurrent(
    buddy, model, dataset, *, epochs, batch_size=32,
    optimizer_name="train_dynamics_recurrent",
):
    root, defn = _model_parts(model)
    dyn = defn.dynamics_model

    def loss_fn(batch):
        states = _time_major(batch["states"])  # (L, B, D)
        pred, _ = dyn.forward_loop(states[0], _time_major(batch["controls"])[1:])
        return torch.mean((pred - states[1:]) ** 2)

    data = _to_device({"states": dataset.states, "controls": dataset.controls},
                      root.device)
    step = _make_step(buddy, root, loss_fn, optimizer_name)
    return _run_epochs(buddy, root, step, data, len(dataset), epochs=epochs,
                       batch_size=batch_size, loss_name="dynamics_recurrent")


# ---------------------------------------------------------------------------
# Measurement pretraining
# ---------------------------------------------------------------------------


def train_pf_measurement(
    buddy, model, dataset, *, epochs, batch_size,
    optimizer_name="train_measurement",
):
    """Pretrain the PF measurement model to regress the Gaussian log-density
    of states perturbed around ground truth (covariance from the dataset)."""
    root, defn = _model_parts(model)
    mm = defn.measurement_model
    enabled = root._enabled_tuple
    device = root.device
    cov = torch.as_tensor(dataset.covariance, device=device)
    chol = torch.linalg.cholesky(cov)
    d = cov.shape[0]
    # Gaussian log-normaliser: -0.5 (D log(2 pi) + log det cov).
    log_norm = -0.5 * (d * math.log(2 * math.pi)
                       + 2.0 * torch.sum(torch.log(torch.diagonal(chol))))

    def loss_fn(batch):
        states = batch["states"]  # (B, D)
        (eps,) = draw_noise(root.generator, (states.shape,), device)
        noise = eps @ chol.T
        white = torch.linalg.solve_triangular(chol, noise.T, upper=False).T
        target = log_norm - 0.5 * torch.sum(white ** 2, dim=-1)
        pred = mm.log_likelihoods((states + noise)[:, None, :], batch["obs"],
                                  enabled=enabled)[:, 0]
        return torch.mean((pred - target) ** 2)

    data = _to_device({"states": dataset.states, "obs": dataset.observations}, device)
    step = _make_step(buddy, root, loss_fn, optimizer_name)
    # An epoch is samples_per_pair passes over the pairs, as in the reference.
    return _run_epochs(buddy, root, step, data, dataset.states.shape[0],
                       epochs=epochs * dataset.samples_per_pair,
                       batch_size=batch_size, loss_name="pf_measurement")


# ---------------------------------------------------------------------------
# End-to-end filter training (BPTT through the filter loop)
# ---------------------------------------------------------------------------


def e2e_loss(defn, batch, *, enabled, initial_cov_scale, generator):
    """The e2e loss of one batch (JAX loops.py:387-413): beliefs at the true
    first state with initial_cov_scale * I, the train-mode filter loop over
    the remaining L-1 steps, then the MSE of the estimates."""
    states = _time_major(batch["states"])  # (L, B, D)
    controls = _time_major(batch["controls"])
    obs = _time_major(batch["obs"])
    seq_len, b, d = states.shape
    m = defn.num_particles(train=True)
    eps0, eps_seq = draw_noise(
        generator, ((b, m, d), (seq_len - 1, b * m, d)), states.device
    )
    cov = torch.eye(d, dtype=states.dtype, device=states.device) * initial_cov_scale
    cov = cov.expand(b, d, d)
    belief = defn.initialize_beliefs(states[0], cov, train=True, eps=eps0)
    _, estimates = defn.forward_loop(
        belief, {k: v[1:] for k, v in obs.items()}, controls[1:], train=True,
        enabled=enabled, eps_seq=eps_seq,
    )
    return torch.mean((estimates - states[1:]) ** 2)


def train_e2e(
    buddy, model, dataset, *, epochs, batch_size=32, initial_cov_scale=0.1,
    measurement_initialize=False, optimizer_name="train_filter_recurrent",
    mesh=None, pipeline_mesh=None, pipeline_microbatches=None,
):
    """BPTT through `subsequence_length` filter steps (torchfilter.train.
    train_filter equivalent), resampling off."""
    del pipeline_microbatches  # read only with a pipeline_mesh
    if mesh is not None or pipeline_mesh is not None:
        raise NotImplementedError(
            "data-parallel and pipelined training are not ported yet (ROADMAP A13)"
        )
    if measurement_initialize:
        raise NotImplementedError(
            "measurement_initialize needs measurement_initialize_beliefs, which "
            "only the EKF family has (not ported yet, ROADMAP A9)"
        )
    root, defn = _model_parts(model)
    enabled = root._enabled_tuple

    def loss_fn(batch):
        return e2e_loss(defn, batch, enabled=enabled,
                        initial_cov_scale=initial_cov_scale, generator=root.generator)

    data = _to_device({"states": dataset.states, "controls": dataset.controls,
                       "obs": dataset.observations}, root.device)
    step = _make_step(buddy, root, loss_fn, optimizer_name)
    return _run_epochs(buddy, root, step, data, len(dataset), epochs=epochs,
                       batch_size=batch_size, loss_name="e2e")
