"""The port's training pieces against the JAX package on the CPU: B2's plain
versions (forward, closed-form backward, autograd of the forward) against
``pf_update_estimate`` in interpret mode (the Pallas kernels' bodies), the
B2 wrapper's device rule, the datasets, the dynamics rollout, the optimizer
rule for missing gradients against optax, module handles and freezing, and
training with autograd switched off globally."""

import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from crossmodal import door_models as jdoor
from multimodalfilter_tpu.data import datasets as jdatasets
from multimodalfilter_tpu.filtering.wrappers import freeze_module as jax_freeze
from multimodalfilter_tpu.ops.pallas_pf import pf_update_estimate as jax_b2
from multimodalfilter_tpu.types import Trajectory as JaxTrajectory
from multimodalfilter_tpu_torch.crossmodal import door_models as tdoor
from multimodalfilter_tpu_torch.crossmodal import train_helpers
from multimodalfilter_tpu_torch.data import datasets as tdatasets
from multimodalfilter_tpu_torch.experiments import Buddy
from multimodalfilter_tpu_torch.filtering.wrappers import freeze_module, unfreeze_module
from multimodalfilter_tpu_torch.ops import pf_estimate
from multimodalfilter_tpu_torch.parallel.mesh import create_mesh
from multimodalfilter_tpu_torch.train import optim
from multimodalfilter_tpu_torch.types import Trajectory

sys.path.insert(0, "tests")
import test_torch_port_dist_worker as worker  # noqa: E402

# fp32 sums over M (and over D) in another order than the Pallas body; the
# values are O(1-10). The same tolerances as the JAX package's own B2 tests
# (tests/test_pallas_pf.py:163-187).
FWD_ATOL = 1e-6
GRAD_ATOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small ops on one thread each, so that a machine busy with other test
    workers does not stall them on an oversubscribed thread pool. Restored
    after the module."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _b2_inputs(n, m, d, seed=0):
    r = np.random.default_rng(seed)
    logits = r.normal(size=(n, m)).astype(np.float32)
    lw = (logits - np.log(np.exp(logits).sum(1, keepdims=True))).astype(np.float32)
    ll = r.normal(size=(n, m)).astype(np.float32)
    particles = r.normal(size=(n, m, d)).astype(np.float32)
    return lw, ll, particles


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


@pytest.mark.parametrize("n,m,d", [(3, 30, 3), (2, 1, 3), (2, 300, 2)])
def test_b2_reference_matches_pallas_forward(n, m, d):
    lw, ll, particles = _b2_inputs(n, m, d)
    jlw, jest = jax_b2(lw, ll, particles, True)
    tlw, test = pf_estimate.pf_update_estimate_reference(*_t(lw, ll, particles))
    np.testing.assert_allclose(np.asarray(jlw), tlw.numpy(), atol=FWD_ATOL, rtol=0)
    np.testing.assert_allclose(np.asarray(jest), test.numpy(), atol=FWD_ATOL, rtol=0)


def _loss_terms(lw2, est, lib):
    """A loss touching both outputs (tests/test_pallas_pf.py:178)."""
    return lib.sum(est ** 2) + lib.sum(lib.exp(lw2) * lib.cos(lw2))


@pytest.mark.parametrize("n,m,d", [(3, 30, 3), (2, 1, 3), (2, 300, 2)])
def test_b2_backward_references_match_pallas_vjp(n, m, d):
    lw, ll, particles = _b2_inputs(n, m, d, seed=1)
    (jlw2, jest), vjp = jax.vjp(lambda a, b, c: jax_b2(a, b, c, True),
                                *map(jnp.asarray, (lw, ll, particles)))
    # The loss's cotangents of (lw', est).
    jlw2, jest = np.asarray(jlw2), np.asarray(jest)
    g_lw = np.exp(jlw2) * (np.cos(jlw2) - np.sin(jlw2))
    g_est = 2 * jest
    jg = [np.asarray(g) for g in vjp((jnp.asarray(g_lw), jnp.asarray(g_est)))]

    # Closed form (the plain version of B2b) from JAX's residuals.
    g_s, g_x = pf_estimate.pf_update_estimate_backward_reference(
        *_t(jlw2, particles, jest, g_lw, g_est)
    )
    for want, got in zip(jg, (g_s, g_s, g_x)):
        np.testing.assert_allclose(want, got.numpy(), atol=GRAD_ATOL, rtol=0)

    # Autograd through the plain forward (what the CPU path runs). Grad mode
    # is opened here: other test files may switch it off (ROADMAP C1).
    args = [x.requires_grad_() for x in _t(lw, ll, particles)]
    with torch.enable_grad():
        _loss_terms(*pf_estimate.pf_update_estimate_reference(*args), torch).backward()
    for want, x in zip(jg, args):
        np.testing.assert_allclose(want, x.grad.numpy(), atol=GRAD_ATOL, rtol=0)


def test_b2_wrapper_takes_the_plain_version_on_cpu_and_raises_off_it():
    args = [x.requires_grad_() for x in _t(*_b2_inputs(2, 50, 3))]
    fwd, bwd = pf_estimate.pf_update_estimate_fwd, pf_estimate.pf_update_estimate_bwd
    before = (fwd.launches, bwd.launches)
    with torch.enable_grad():
        out = pf_estimate.pf_update_estimate(*args)
        ref = pf_estimate.pf_update_estimate_reference(*args)
        for a, b in zip(out, ref):
            torch.testing.assert_close(a, b, atol=0, rtol=0)
        _loss_terms(*out, torch).backward()
    assert all(x.grad is not None for x in args)

    n, m, d = 2, 8, 3
    meta = [torch.empty(n, m, device="meta"), torch.empty(n, m, device="meta"),
            torch.empty(n, m, d, device="meta")]
    with pytest.raises(ValueError, match="need CUDA tensors"):
        pf_estimate.pf_update_estimate(*meta)
    with pytest.raises(ValueError, match="need CUDA tensors"):
        bwd(meta[0], meta[2], torch.empty(n, d, device="meta"), meta[1],
            torch.empty(n, d, device="meta"))
    assert (fwd.launches, bwd.launches) == before


# ---------------------------------------------------------------------------
# Datasets and the dynamics rollout
# ---------------------------------------------------------------------------


def _trajectories(lengths, seed=0, cls=Trajectory):
    r = np.random.default_rng(seed)
    out = []
    for t in lengths:
        obs = {"image": r.normal(size=(t, 32, 32)).astype(np.float32),
               "gripper_pos": r.normal(size=(t, 3)).astype(np.float32),
               "gripper_sensors": r.normal(size=(t, 7)).astype(np.float32)}
        out.append(cls(r.normal(size=(t, 3)).astype(np.float32), obs,
                       r.normal(size=(t, 7)).astype(np.float32)))
    return out


def _assert_same_arrays(jds, tds, names):
    for name in names:
        want, got = getattr(jds, name), getattr(tds, name)
        if isinstance(want, dict):
            assert want.keys() == got.keys()
            for k in want:
                np.testing.assert_array_equal(want[k], got[k])
        else:
            np.testing.assert_array_equal(want, got)
    assert len(jds) == len(tds)


@pytest.mark.parametrize("stride", [None, 2, 5])
def test_datasets_match_jax(stride):
    lengths = (9, 3, 12)
    jt = _trajectories(lengths, cls=JaxTrajectory)
    tt = _trajectories(lengths)
    _assert_same_arrays(
        jdatasets.SubsequenceDataset(jt, 4, stride=stride),
        tdatasets.SubsequenceDataset(tt, 4, stride=stride),
        ("states", "observations", "controls"),
    )
    if stride is None:
        _assert_same_arrays(jdatasets.SingleStepDataset(jt), tdatasets.SingleStepDataset(tt),
                            ("previous_states", "states", "observations", "controls"))
        cov = np.eye(3) * 0.1
        _assert_same_arrays(
            jdatasets.ParticleFilterMeasurementDataset(jt, cov, samples_per_pair=3),
            tdatasets.ParticleFilterMeasurementDataset(tt, cov, samples_per_pair=3),
            ("states", "observations", "covariance"),
        )


def test_subsequence_dataset_rejects_what_it_cannot_window():
    with pytest.raises(ValueError, match="No trajectory long enough"):
        tdatasets.SubsequenceDataset(_trajectories((3,)), 4)
    with pytest.raises(ValueError, match="out of bounds"):
        tdatasets._window_gather(np.zeros((5, 2), np.float32), np.array([3]), 4)


@pytest.fixture(scope="module")
def crossmodal_models():
    jm = jdoor.DoorCrossmodalParticleFilter()
    tm = tdoor.DoorCrossmodalParticleFilter(device="cpu")
    tm.load_jax_params(jm.params)
    return jm, tm


def test_dynamics_forward_loop_matches_jax(crossmodal_models):
    jm, tm = crossmodal_models
    r = np.random.default_rng(3)
    x0 = r.normal(size=(4, 3)).astype(np.float32)
    controls = r.normal(size=(6, 4, 7)).astype(np.float32)
    jdyn = jm.definition.dynamics_model
    js, jtril = jdyn.forward_loop(jm.params["dynamics_model"], x0, controls)
    with torch.no_grad():
        ts, ttril = tm.definition.dynamics_model.forward_loop(*_t(x0, controls))
    # fp32 64-wide MLP trunks in two frameworks over a 6-step recursion.
    np.testing.assert_allclose(np.asarray(js), ts.numpy(), atol=1e-5, rtol=0)
    np.testing.assert_array_equal(np.asarray(jtril), ttril.numpy())


# ---------------------------------------------------------------------------
# Optimizer, handles, freezing
# ---------------------------------------------------------------------------


def test_missing_gradients_step_like_optax():
    """Step 1 reaches both layers; steps 2-3 reach only "b". optax steps "a"
    on its zero gradient (its moments decay); so must the port."""
    torch.manual_seed(0)
    module = torch.nn.ModuleDict({"a": torch.nn.Linear(3, 2), "b": torch.nn.Linear(3, 2)})
    params = {k: v.detach().numpy().copy() for k, v in module.state_dict().items()}
    tx = optax.adam(optim.DEFAULT_LEARNING_RATE)
    state = tx.init(params)
    opt = optim.make_optimizer(module.parameters())
    x = torch.randn(5, 3)
    a_after_step1 = None
    for step in range(3):
        opt.zero_grad(set_to_none=True)
        with torch.enable_grad():
            out = module["b"](x) + (module["a"](x) if step == 0 else 0.0)
            (out ** 2).sum().backward()
        assert (module["a"].weight.grad is None) == (step > 0)
        grads = {k: (np.zeros_like(params[k]) if p.grad is None else p.grad.numpy().copy())
                 for k, p in module.named_parameters()}
        optim.apply_gradients(opt, module, frozenset())
        updates, state = tx.update(grads, state, params)
        params = optax.apply_updates(params, updates)
        for k, v in module.state_dict().items():
            # Adam in fp32 either way; only rounding differs.
            np.testing.assert_allclose(np.asarray(params[k]), v.numpy(), rtol=1e-6, atol=1e-9)
        if step == 0:
            a_after_step1 = module["a"].weight.detach().clone()
    assert (module["a"].weight.detach() != a_after_step1).all()


def test_zero_frozen_grads_by_prefix():
    module = torch.nn.ModuleDict({
        "m": torch.nn.ModuleDict({"x": torch.nn.Linear(2, 2), "xy": torch.nn.Linear(2, 2)}),
        "n": torch.nn.Linear(2, 2),
    })
    for p in module.parameters():
        p.grad = torch.ones_like(p)
    optim.zero_frozen_grads(module, {"m.x"})
    zeroed = {k for k, p in module.named_parameters() if not p.grad.any()}
    assert zeroed == {"m.x.weight", "m.x.bias"}
    optim.zero_frozen_grads(module, {""})
    assert not any(p.grad.any() for p in module.parameters())


def test_handles_and_frozen_paths_match_jax(crossmodal_models):
    jm, tm = crossmodal_models
    jm.frozen_paths.clear()
    for model, freeze in ((jm, jax_freeze), (tm, freeze_module)):
        mm = model.measurement_model
        freeze(mm.crossmodal_weight_model)
        freeze(mm.measurement_models)
        freeze(model.dynamics_model)
        freeze(mm.measurement_models[1])
    assert tm.frozen_paths == jm.frozen_paths
    keys = set(tm.params.state_dict())
    for path in tm.frozen_paths:
        assert any(k.startswith(path + ".") for k in keys), path
    unfreeze_module(tm.dynamics_model)
    assert "dynamics_model" not in tm.frozen_paths
    tm.frozen_paths.clear()
    jm.frozen_paths.clear()

    tm.measurement_model.enabled_models = [True, False]
    assert tm.enabled_models == [True, False] and tm._enabled_tuple == (True, False)
    tm.enabled_models = [True, True]
    assert tm.measurement_model.measurement_models[0].params is \
        tm.params["measurement_model"]["measurement_models"]["0"]
    with pytest.raises(AttributeError, match="no submodule"):
        tm.measurement_model.not_a_field


# ---------------------------------------------------------------------------
# Training with autograd switched off globally (ROADMAP C1)
# ---------------------------------------------------------------------------


def _door_model(m=4, seed=0):
    model = tdoor.DoorCrossmodalParticleFilter(device="cpu", seed=seed)
    model.definition = dataclasses.replace(model.definition, num_particles_train=m)
    return model


def test_train_e2e_under_global_no_grad(tmp_path):
    model = _door_model()
    before = {k: v.clone() for k, v in model.params.state_dict().items()}
    buddy = Buddy("c1", model, log_dir=str(tmp_path))
    train_helpers.configure(buddy=buddy, trajectories=_trajectories((8, 8)))
    state = torch.is_grad_enabled()
    torch.set_grad_enabled(False)
    try:
        loss = train_helpers.train_e2e(subsequence_length=3, epochs=1, batch_size=2)
        assert not torch.is_grad_enabled()
    finally:
        torch.set_grad_enabled(state)
    assert np.isfinite(loss) and buddy.optimizer_steps == 2
    after = model.params.state_dict()
    assert all(not torch.equal(after[k], v) for k, v in before.items())
    assert (tmp_path / "c1" / "metrics.jsonl").read_text().count("train/e2e") == 1


def test_frozen_module_gets_no_update_from_a_fresh_optimizer(tmp_path):
    model = _door_model(seed=1)
    buddy = Buddy("frozen", model, log_dir=str(tmp_path))
    train_helpers.configure(buddy=buddy, trajectories=_trajectories((8, 8), seed=1))
    freeze_module(model.measurement_model.crossmodal_weight_model)
    before = {k: v.clone() for k, v in model.params.state_dict().items()}
    train_helpers.train_e2e(subsequence_length=3, epochs=1, batch_size=2)
    for k, v in model.params.state_dict().items():
        frozen = k.startswith("measurement_model.crossmodal_weight_model.")
        assert torch.equal(v, before[k]) == frozen, k


def test_mesh_training_is_not_ported(tmp_path):
    """train_helpers.configure takes a data-parallel mesh: in a world of one
    process train_e2e on it is train_e2e on one device, bit for bit. A mesh
    that does not fit is refused: one without a 'data' axis, both meshes at
    once, and a data axis the batch does not divide over (a 3-way stand-in
    for a batch of 2: this world has one rank; test_torch_port_multidevice
    .py trains on four)."""
    params = {}
    trajectories = _trajectories((8, 8), seed=2)
    with worker.world_of_one():
        mesh = create_mesh(1, device="cpu")
        for name, use_mesh in (("mesh", mesh), ("single", None)):
            model = _door_model(seed=3)
            buddy = Buddy("mesh", model, log_dir=str(tmp_path / name))
            train_helpers.configure(buddy=buddy, trajectories=trajectories, mesh=use_mesh)
            train_helpers.train_e2e(subsequence_length=3, epochs=1, batch_size=2)
            params[name] = model.params.state_dict()
        with pytest.raises(ValueError, match="'data' axis"):
            train_helpers.configure(buddy=buddy, trajectories=trajectories,
                                    mesh=create_mesh(1, ("pipe",), device="cpu"))
        with pytest.raises(ValueError, match="exclusive"):
            train_helpers.configure(buddy=buddy, trajectories=trajectories, mesh=mesh,
                                    pipeline_mesh=mesh)
    for k, v in params["single"].items():
        assert torch.equal(params["mesh"][k], v), k
    train_helpers.configure(buddy=buddy, trajectories=trajectories,
                            mesh=worker.AxisSizes(data=3))
    with pytest.raises(ValueError, match="does not divide"):
        train_helpers.train_e2e(subsequence_length=3, epochs=1, batch_size=2)
