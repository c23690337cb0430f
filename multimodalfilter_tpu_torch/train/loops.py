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
- The serving transforms (the folded encoder tail, stacked encoders, bf16
  encoder compute) are stripped from a def before it trains
  (``_strip_serving_transforms``), as in the JAX package: a model built
  under ``MMF_TPU_SERVING=1`` trains exactly as a plain one, and its own
  def, which eval reads, keeps them.

Losses:
  dynamics single-step / recurrent: MSE of predicted vs true next states
  measurement pretraining:          MSE of predicted vs Gaussian log-density
  virtual sensor pretraining:       MSE of the virtual sensor's z vs the
                                    true state
  e2e filter:                       MSE of filter estimates vs true states
                                    (beliefs initialised at the true first
                                    state with initial_cov_scale * I, or
                                    from the first frame's observations
                                    with measurement_initialize)
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..filtering import base as _base
from ..utils.precision import with_compute_dtype, with_fold_tail, with_stacked_encoders
from .optim import apply_gradients, get_named_optimizer


def draw_noise(generator: torch.Generator, shapes, device):
    """Standard-normal tensors of `shapes`, drawn in order from `generator`:
    all the per-batch noise of the train loops (the initial belief's eps and
    the filter's eps_seq in e2e training, the perturbations in measurement
    pretraining)."""
    return tuple(torch.randn(tuple(s), generator=generator, device=device)
                 for s in shapes)


def _strip_serving_transforms(defn):
    """`defn` without the serving-only execution transforms (JAX
    loops.py:46-68): no folded tail and no stacked encoders (the same maps
    on the same parameters, so training without them is exact and skips
    rebuilding the folded weight every step) and fp32 encoders (bf16 would
    change training's numerics). The def is rebuilt around the same
    networks, so the parameters trained are the model's own."""
    defn = with_stacked_encoders(with_fold_tail(defn, False), False)
    return with_compute_dtype(defn, None)


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


def _make_step(buddy, root, loss_fn, optimizer_name, shard=None):
    """fn(batch) -> detached loss: one optimizer step of the named Adam over
    all of the root filter's parameters. With a `shard`
    (``parallel.data_parallel.TrainShard``) the gradients and the loss are
    all-reduced over its mesh before the step, and the loss returned is the
    global batch's."""
    optimizer = get_named_optimizer(buddy, optimizer_name, root.params)
    frozen = frozenset(root.frozen_paths)

    def step(batch):
        optimizer.zero_grad(set_to_none=True)
        with torch.enable_grad():
            loss = loss_fn(batch)
            loss.backward()
        if shard is None:
            apply_gradients(optimizer, root.params, frozen)
            return loss.detach()
        return apply_gradients(optimizer, root.params, frozen,
                               reduce=lambda module: shard.all_reduce_gradients(module, loss))

    return step


def _run_epochs(buddy, root, step, data, n, *, epochs, batch_size, loss_name,
                rows: slice = slice(None)):
    """Shuffled epochs of `step` over batches of `batch_size`; each step
    gets `rows` of its batch (a rank's rows on a data-parallel mesh)."""
    rng = np.random.default_rng(buddy.optimizer_steps + 1)
    last_loss = None
    for _ in range(epochs):
        idx_matrix = torch.as_tensor(_epoch_index_matrix(rng, n, batch_size),
                                     device=root.device)
        losses = torch.stack([step(_gather(data, idx[rows])) for idx in idx_matrix])
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
    mm = _strip_serving_transforms(defn.measurement_model)
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


def train_virtual_sensor(
    buddy, model, dataset, *, epochs, batch_size=32,
    optimizer_name="train_virtual_sensor",
):
    """Pretrain a Kalman filter's virtual sensor to regress the true state
    from the observations (the enabled modalities reach a fusion sensor)."""
    root, defn = _model_parts(model)
    vs = _strip_serving_transforms(defn.virtual_sensor_model)
    enabled = root._enabled_tuple

    def loss_fn(batch):
        z, _ = vs.apply(batch["obs"], enabled=enabled)
        return torch.mean((z - batch["next"]) ** 2)

    data = _to_device({"next": dataset.states, "obs": dataset.observations}, root.device)
    step = _make_step(buddy, root, loss_fn, optimizer_name)
    return _run_epochs(buddy, root, step, data, len(dataset), epochs=epochs,
                       batch_size=batch_size, loss_name="virtual_sensor")


# ---------------------------------------------------------------------------
# End-to-end filter training (BPTT through the filter loop)
# ---------------------------------------------------------------------------


def e2e_loss(defn, batch, *, enabled, initial_cov_scale, generator,
             measurement_initialize=False, shard=None):
    """The e2e loss of one batch (JAX loops.py:387-413): beliefs at the true
    first state with initial_cov_scale * I (or, with
    `measurement_initialize`, from the first frame's observations), the
    train-mode filter loop over the remaining L-1 steps, then the MSE of the
    estimates. A particle filter's noise (the initial particles' and each
    step's) comes from ``draw_noise``; a def without particles (the Kalman
    filters, the LSTM) draws nothing.

    With a `shard` (``parallel.data_parallel.TrainShard``) `batch` is this
    rank's rows of the global batch: the noise is drawn for the global
    batch and sliced to those rows, the loop is the shard's, and the loss
    is the mean over the rows."""
    states = _time_major(batch["states"])  # (L, B, D)
    controls = _time_major(batch["controls"])
    obs = _time_major(batch["obs"])
    seq_len, b, d = states.shape
    init_noise, loop_noise = {}, {}
    if hasattr(defn, "num_particles"):
        m = defn.num_particles(train=True)
        total = b if shard is None else shard.batch_size
        eps, eps_seq = draw_noise(
            generator, ((total, m, d), (seq_len - 1, total * m, d)), states.device
        )
        if shard is not None:
            eps = eps[shard.rows]
            eps_seq = eps_seq.reshape(seq_len - 1, total, m, d)[:, shard.rows].reshape(
                seq_len - 1, b * m, d)
        init_noise["eps"], loop_noise["eps_seq"] = eps, eps_seq
    if measurement_initialize:
        belief = _base.measurement_initialize(defn, {k: v[0] for k, v in obs.items()},
                                              enabled=enabled, train=True)
    else:
        cov = torch.eye(d, dtype=states.dtype, device=states.device) * initial_cov_scale
        belief = defn.initialize_beliefs(states[0], cov.expand(b, d, d), train=True,
                                         **init_noise)
    obs_rest = {k: v[1:] for k, v in obs.items()}
    if shard is None:
        _, estimates = defn.forward_loop(belief, obs_rest, controls[1:], train=True,
                                         enabled=enabled, **loop_noise)
    else:
        _, estimates = shard.loop(defn, belief, obs_rest, controls[1:], enabled=enabled,
                                  **loop_noise)
    return torch.mean((estimates - states[1:]) ** 2)


def train_e2e(
    buddy, model, dataset, *, epochs, batch_size=32, initial_cov_scale=0.1,
    measurement_initialize=False, optimizer_name="train_filter_recurrent",
    mesh=None, pipeline_mesh=None, pipeline_microbatches=None,
):
    """BPTT through `subsequence_length` filter steps (torchfilter.train.
    train_filter equivalent), resampling off.

    With `mesh` (a "data" axis) the batch splits data-parallel over it:
    each rank takes its rows of every batch and the global draws sliced to
    them, and one all-reduce a step averages the gradients. With
    `pipeline_mesh` BPTT runs through the temporal pipeline on its "pipe"
    axis ((subsequence_length - 1) must divide over the stages), the
    relay differentiable; a "data" axis on it splits the batch as `mesh`
    does and a "particle" axis splits a PF's particles, all three composing.
    `pipeline_microbatches` None takes the largest divisor of the per-shard
    batch up to 8. The two meshes are exclusive. Every rank starts from
    rank 0's parameters and steps Adam on the same reduced gradients."""
    if mesh is not None and pipeline_mesh is not None:
        raise ValueError("mesh (data-parallel) and pipeline_mesh (pipelined) are exclusive")
    root, defn = _model_parts(model)
    defn = _strip_serving_transforms(defn)
    enabled = root._enabled_tuple
    shard = None
    if mesh is not None or pipeline_mesh is not None:
        from ..parallel.data_parallel import train_shard

        shard = train_shard(defn, pipeline_mesh if mesh is None else mesh,
                            batch_size=batch_size, seq_len=dataset.subsequence_length,
                            pipelined=mesh is None, microbatches=pipeline_microbatches)
        shard.broadcast_parameters(root.params)

    def loss_fn(batch):
        return e2e_loss(defn, batch, enabled=enabled,
                        initial_cov_scale=initial_cov_scale, generator=root.generator,
                        measurement_initialize=measurement_initialize, shard=shard)

    data = _to_device({"states": dataset.states, "controls": dataset.controls,
                       "obs": dataset.observations}, root.device)
    step = _make_step(buddy, root, loss_fn, optimizer_name, shard)
    return _run_epochs(buddy, root, step, data, len(dataset), epochs=epochs,
                       batch_size=batch_size, loss_name="e2e",
                       rows=slice(None) if shard is None else shard.rows)
