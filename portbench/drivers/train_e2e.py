"""End-to-end training through ``train/loops.py::train_e2e``: BPTT over
subsequences of L steps, the named Adam of ``train/optim.py``.

An epoch is one ``train_e2e`` call over the whole set, B rows a step. Set-up
builds one model and its optimizer and drives them from the seed through
their first epoch, which is also the warm-up. The window then runs epochs
back to back on the same model and optimizer. Before each epoch it keeps a
copy of the parameters and of Adam's moments; an optimizer hook keeps each
gradient as Adam gets it at the epoch's first three steps and the
parameters after the third (~240 device copies an epoch of some 88,000
launches).

``correct``: the reference, with an Adam of its own, follows the first
three steps

- of the first epoch from the seed's weights: each step's loss (observed
  in set-up as ``train_e2e`` takes its backward), the norm of each leaf's
  first gradient and of each leaf's change after step three;
- of the window's last epoch from the copy made before it: the norm of
  each leaf's gradient at each of the three steps (the middle of the
  three steps' median-leaf gaps is compared).

Every step's noise comes from the model's generator, seeded from the run's
seed, in a fixed order that the reference draws again from that seed;
``train_e2e`` orders a call's batches by
``numpy.random.default_rng(steps + 1)``.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch
from torch.optim.optimizer import register_optimizer_step_post_hook
from torch.overrides import TorchFunctionMode
from torch.profiler import record_function

from portbench import inputs, program
from portbench.reference import filters

OPTIMIZER = "train_filter_recurrent"  # train_e2e's default optimizer name
FOLLOWED = 3  # the steps of an epoch that the reference follows


class Buddy:
    """What ``train_e2e`` asks of its experiment object: the optimizer
    step count, the named optimizers and a scalar log (kept in memory)."""

    def __init__(self):
        self._optimizer_dict = {}
        self._steps = 0
        self.logged = []

    @property
    def optimizer_steps(self) -> int:
        return self._steps

    def increment_steps(self, n: int = 1) -> None:
        self._steps += n

    def log_scalar(self, name: str, value: float) -> None:
        self.logged.append((name, value))


class Subsequences:
    """Rows of the training set, as ``train_e2e`` reads a dataset."""

    def __init__(self, data, rows: slice, seq_len: int):
        self.states = data["states"][rows]
        self.controls = data["controls"][rows]
        self.observations = {k: v[rows] for k, v in data["obs"].items()}
        self.subsequence_length = seq_len

    def __len__(self):
        return self.states.shape[0]


class Probe:
    """An optimizer hook that keeps, for the epoch under way, each gradient
    as Adam gets it at the first three steps and the parameters after the
    third (copies, by leaf name)."""

    def __init__(self, module):
        self.named = dict(module.named_parameters())
        self.reset()

    def reset(self):
        self.steps, self.grads, self.after = 0, [], {}

    def __call__(self, optimizer, args, kwargs):
        self.steps += 1
        if self.steps <= FOLLOWED:
            self.grads.append({k: p.grad.detach().clone() for k, p in self.named.items()})
        if self.steps == FOLLOWED:
            self.after = {k: p.detach().clone() for k, p in self.named.items()}


class Losses(TorchFunctionMode):
    """Keeps each loss that a backward is taken of (a copy)."""

    def __init__(self):
        super().__init__()
        self.losses = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func is torch.Tensor.backward:
            self.losses.append(args[0].detach().clone())
        return func(*args, **(kwargs or {}))


@dataclasses.dataclass
class Readings:
    """What is compared of one side: the first epoch's first losses, each
    leaf's first gradient's norm and change's norm after step three; the
    last epoch's gradients' norms at each of its first three steps."""

    first_losses: list
    first_grads: dict
    first_updates: dict
    last_grads: list


@dataclasses.dataclass
class State:
    run: object
    model: object
    weights: dict
    data: dict
    buddy: Buddy
    noise_seed: int
    probe: Probe
    hook: object
    first: dict = dataclasses.field(default_factory=dict)
    before_last: dict = dataclasses.field(default_factory=dict)


def _train(state, rows: slice):
    from multimodalfilter_tpu_torch.train.loops import train_e2e

    traffic = state.run.traffic
    dataset = Subsequences(state.data, rows, traffic["L"])
    return train_e2e(state.buddy, state.model, dataset, epochs=1, batch_size=traffic["B"],
                     initial_cov_scale=traffic["initial_cov_scale"])


def _epoch(state):
    state.probe.reset()
    return _train(state, slice(0, state.run.traffic["subsequences"]))


def _optimizer_state(state) -> dict:
    """A copy of the parameters and of Adam's moments, by leaf name."""
    optimizer = state.buddy._optimizer_dict[OPTIMIZER]
    named = list(state.model.params.named_parameters())
    return {"steps": state.buddy.optimizer_steps,
            "params": {k: p.detach().clone() for k, p in named},
            "m": {k: optimizer.state[p]["exp_avg"].clone() for k, p in named},
            "v": {k: optimizer.state[p]["exp_avg_sq"].clone() for k, p in named}}


def setup(run) -> State:
    model, weights = program.build_model(run)
    model.train()
    data = inputs.train_subsequences(run.config, run.traffic, run.seed, run.device)
    noise_seed = inputs.stream_seed(run.seed, "train_noise")
    model.generator.manual_seed(noise_seed)
    probe = Probe(model.params)
    state = State(run, model, weights, data, Buddy(), noise_seed, probe,
                  register_optimizer_step_post_hook(probe))
    with Losses() as seen:
        _epoch(state)
    state.first = {"losses": [float(x) for x in seen.losses[:FOLLOWED]],
                   "grads": state.probe.grads, "after": state.probe.after}
    return state


def window(state: State, seconds: float) -> dict:
    traffic = state.run.traffic
    steps, spans = 0, []
    start = time.perf_counter()
    while True:
        before = _optimizer_state(state)
        t0 = time.perf_counter()
        _epoch(state)  # returns a float: synchronised
        spans.append((t0, time.perf_counter()))
        steps += state.buddy.optimizer_steps - before["steps"]
        if spans[-1][1] - start >= seconds:
            break
    elapsed = spans[-1][1] - start
    state.before_last = dict(before, grads=state.probe.grads, after=state.probe.after)
    rate = steps * traffic["B"] * (traffic["L"] - 1) / elapsed
    return {"e2e": {"train_steps_per_s": rate}, "attempted": steps, "failed": 0,
            "window_s": elapsed, "optimizer_steps": steps, "spans": spans}


def traced(state: State) -> dict:
    b, k = state.run.traffic["B"], state.run.traffic["trace_steps"]
    with record_function("portbench.train_call"):
        _train(state, slice(0, k * b))
    return {"optimizer_steps": k}


def _norms(tensors: dict) -> dict:
    return {k: float(v.norm()) for k, v in tensors.items()}


def _changes(after: dict, before: dict) -> dict:
    return {k: float((after[k] - before[k]).norm()) for k in before}


def program_readings(state: State) -> Readings:
    first, last = state.first, state.before_last
    return Readings(first["losses"], _norms(first["grads"][0]),
                    _changes(first["after"], state.weights),
                    [_norms(g) for g in last["grads"]])


def _epoch_order(n: int, b: int, steps_before: int) -> np.ndarray:
    """The rows of each step of an epoch that starts after `steps_before`
    optimizer steps: a permutation by ``default_rng(steps_before + 1)``,
    the last partial batch dropped."""
    perm = np.random.default_rng(steps_before + 1).permutation(n)
    return perm[: (n // b) * b].reshape(n // b, b)


def _draw_noise(state: State, g: torch.Generator):
    b, seq_len = state.run.traffic["B"], state.run.traffic["L"]
    m, d = state.run.traffic["M"], state.run.config["state_dim"]
    eps0 = torch.randn((b, m, d), generator=g, device=state.run.device)
    eps_seq = torch.randn((seq_len - 1, b * m, d), generator=g, device=state.run.device)
    return eps0, eps_seq


def _follow(state: State, params: dict, adam, g, steps_before: int, loss_fn):
    """The reference over the first three steps of an epoch from `params`
    and `adam`: the steps' losses, their gradients' norms and the
    parameters after the third."""
    traffic, cfg, data = state.run.traffic, state.run.config, state.data
    losses, grad_norms = [], []
    order = _epoch_order(traffic["subsequences"], traffic["B"], steps_before)
    for k, rows in enumerate(order[:FOLLOWED]):
        eps0, eps_seq = _draw_noise(state, g)
        rows = torch.as_tensor(rows, device=state.run.device)
        leaves = {key: v.detach().clone().requires_grad_(True) for key, v in params.items()}
        loss = loss_fn(leaves, cfg, data["states"][rows], data["controls"][rows],
                       {key: v[rows] for key, v in data["obs"].items()}, eps0, eps_seq,
                       traffic["initial_cov_scale"])
        grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
        losses.append(float(loss.detach()))
        grad_norms.append(_norms(grads))
        with torch.no_grad():
            params = adam.step({key: v.detach() for key, v in leaves.items()}, grads)
    return losses, grad_norms, params


def reference_readings(state: State, loss_fn=filters.e2e_loss) -> Readings:
    """The reference's readings: the first epoch from the seed's weights
    and a fresh Adam; the window's last epoch from the program's copy of
    its parameters and Adam's moments before it (the steps between are
    skipped, their noise drawn and dropped)."""
    lr, run = state.run.traffic["learning_rate"], state.run
    g = torch.Generator(device=run.device).manual_seed(state.noise_seed)
    adam = filters.Adam(state.weights, lr=lr)
    first_losses, first_grads, after = _follow(state, state.weights, adam, g, 0, loss_fn)
    before = state.before_last
    for _ in range(before["steps"] - FOLLOWED):
        _draw_noise(state, g)
    adam = filters.Adam(before["params"], lr=lr, moments=(before["m"], before["v"]),
                        t=before["steps"])
    _, last_grads, _ = _follow(state, before["params"], adam, g, before["steps"], loss_fn)
    return Readings(first_losses, first_grads[0], _changes(after, state.weights), last_grads)


def leaf_gaps(got: dict, ref: dict, names) -> dict:
    """Each leaf of `names`: the gap between the two norms, over the larger
    of the reference's norm of that leaf and of the median leaf."""
    median = float(np.median(list(ref.values())))
    return {k: abs(got[k] - ref[k]) / max(ref[k], median) for k in names}


def median_leaf_gap(got: dict, ref: dict, names) -> float:
    return float(np.median(list(leaf_gaps(got, ref, names).values())))


def moved(grads: dict) -> list:
    """The leaves whose reference gradient is more than a thousandth of the
    median leaf's: the others move under Adam by round-off alone."""
    median = float(np.median(list(grads.values())))
    return [k for k, v in grads.items() if v >= 1e-3 * median]


def compare(state: State, got: Readings, ref: Readings) -> list:
    """(name, value, limit) of each compared number. Why the first step's
    loss and the median leaf, and not every step and the worst leaf:
    PERF.md, the limits."""
    limits = state.run.cell.limits
    numbers = {
        "loss_gap_first_step": abs(got.first_losses[0] - ref.first_losses[0])
        / abs(ref.first_losses[0]),
        "grad_norm_gap_median_leaf": median_leaf_gap(got.first_grads, ref.first_grads,
                                                     ref.first_grads),
        "update_norm_gap_median_leaf": median_leaf_gap(got.first_updates, ref.first_updates,
                                                       moved(ref.first_grads)),
        "grad_norm_gap_median_leaf_last_epoch": float(np.median(
            [median_leaf_gap(a, b, b) for a, b in zip(got.last_grads, ref.last_grads)])),
    }
    return [(name, value, limits[name]) for name, value in numbers.items()]


def release(state: State) -> None:
    """Removes the optimizer hook and frees the program's state."""
    state.hook.remove()
    state.model = state.buddy = state.probe = None
    if state.run.device.type == "cuda":
        torch.cuda.empty_cache()


def check(state: State) -> list:
    got = program_readings(state)
    release(state)
    return compare(state, got, reference_readings(state))
