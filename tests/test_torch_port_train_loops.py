"""The crossmodal PF curriculum's other training primitives, the port against
the JAX package on the CPU at full width (units=64): dynamics single-step
and recurrent pretraining, and measurement-model pretraining with the image
model alone enabled (the curriculum's phase 2). Both sides start from the
same weights and see the same batches; measurement pretraining's
perturbations are JAX's draws, replayed through ``train.loops.draw_noise``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crossmodal import door_models as jdoor
from multimodalfilter_tpu import train as jtrain
from multimodalfilter_tpu.data import datasets as jdatasets
from multimodalfilter_tpu.experiments import Buddy as JaxBuddy
from multimodalfilter_tpu.types import Trajectory as JaxTrajectory
from multimodalfilter_tpu_torch import train as ttrain
from multimodalfilter_tpu_torch.crossmodal import door_models as tdoor
from multimodalfilter_tpu_torch.data import datasets as tdatasets
from multimodalfilter_tpu_torch.experiments import Buddy
from multimodalfilter_tpu_torch.train import loops as tloops
from multimodalfilter_tpu_torch.types import Trajectory
from multimodalfilter_tpu_torch.weights import params_from_jax

# Losses: fp32 nets in two frameworks, reassociated sums.
LOSS_RTOL = 1e-5
# Each parameter's update over the run, in relative L2 norm (see
# test_torch_port_train_e2e.py for why Adam's updates are held this way).
UPDATE_RTOL = 1e-2


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small ops on one thread each, so that a machine busy with other test
    workers does not stall them on an oversubscribed thread pool. Restored
    after the module."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _trajectories(cls, count=2, t=12, seed=0):
    r = np.random.default_rng(seed)
    out = []
    for _ in range(count):
        obs = {"image": r.normal(size=(t, 32, 32)).astype(np.float32),
               "gripper_pos": r.normal(size=(t, 3)).astype(np.float32),
               "gripper_sensors": r.normal(size=(t, 7)).astype(np.float32)}
        states = np.cumsum(0.1 * r.normal(size=(t, 3)), axis=0).astype(np.float32)
        out.append(cls(states, obs, r.normal(size=(t, 7)).astype(np.float32)))
    return out


@pytest.fixture(scope="module")
def initial():
    jm = jdoor.DoorCrossmodalParticleFilter()
    return jm, jax.tree_util.tree_map(np.array, jm.params)


@pytest.fixture
def pair(initial, tmp_path):
    jm, params = initial
    jm.params = jax.tree_util.tree_map(jnp.array, params)
    jm.enabled_models = [True, True]
    tm = tdoor.DoorCrossmodalParticleFilter(device="cpu")
    tm.load_jax_params(params)
    jbuddy = JaxBuddy("loops", jm, checkpoint_dir=str(tmp_path), metadata_dir=str(tmp_path),
                      log_dir=str(tmp_path / "jax"), verbose=False)
    tbuddy = Buddy("loops", tm, log_dir=str(tmp_path / "torch"))
    start = {k: v.detach().clone() for k, v in tm.params.state_dict().items()}
    return jm, tm, jbuddy, tbuddy, start


def _assert_same_training(jm, tm, jbuddy, tbuddy, start, jloss, tloss):
    assert tbuddy.optimizer_steps == jbuddy.optimizer_steps > 0
    np.testing.assert_allclose(tloss, jloss, rtol=LOSS_RTOL)
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, jm.params))
    got = tm.params.state_dict()
    for k in want:
        dj, dt = want[k] - start[k], got[k] - start[k]
        if not dj.any():  # not reached by this loss, fresh optimizer: no step
            assert not dt.any(), k
            continue
        rel = float((dt - dj).norm() / dj.norm())
        assert rel <= UPDATE_RTOL, f"{k}: update differs by {rel:.3g} of its norm"


def test_dynamics_single_step_matches_jax(pair):
    jm, tm, jbuddy, tbuddy, start = pair
    jloss = jtrain.train_dynamics_single_step(
        jbuddy, jm, jdatasets.SingleStepDataset(_trajectories(JaxTrajectory)),
        epochs=2, batch_size=8)
    tloss = ttrain.train_dynamics_single_step(
        tbuddy, tm, tdatasets.SingleStepDataset(_trajectories(Trajectory)),
        epochs=2, batch_size=8)
    _assert_same_training(jm, tm, jbuddy, tbuddy, start, jloss, tloss)


def test_dynamics_recurrent_matches_jax(pair):
    jm, tm, jbuddy, tbuddy, start = pair
    jloss = jtrain.train_dynamics_recurrent(
        jbuddy, jm, jdatasets.SubsequenceDataset(_trajectories(JaxTrajectory), 4),
        epochs=2, batch_size=2)
    tloss = ttrain.train_dynamics_recurrent(
        tbuddy, tm, tdatasets.SubsequenceDataset(_trajectories(Trajectory), 4),
        epochs=2, batch_size=2)
    _assert_same_training(jm, tm, jbuddy, tbuddy, start, jloss, tloss)


def test_pf_measurement_matches_jax(pair, monkeypatch):
    jm, tm, jbuddy, tbuddy, start = pair
    for model in (jm, tm):
        model.measurement_model.enabled_models = [True, False]
    cov = np.eye(3) * 0.1
    batch = 8
    jds = jdatasets.ParticleFilterMeasurementDataset(_trajectories(JaxTrajectory), cov,
                                                     samples_per_pair=2)
    tds = tdatasets.ParticleFilterMeasurementDataset(_trajectories(Trajectory), cov,
                                                     samples_per_pair=2)
    # JAX's draws: one key per epoch from the filter's chain, split per
    # batch, normal(key, (B, D)) per batch (loops.py:101, :136, :228).
    rng, draws = jm._rng, []
    for _ in range(tds.samples_per_pair):
        rng, key = jax.random.split(rng)
        for k in jax.random.split(key, tds.states.shape[0] // batch):
            draws.append(np.array(jax.random.normal(k, (batch, 3))))
    jloss = jtrain.train_pf_measurement(jbuddy, jm, jds, epochs=1, batch_size=batch)

    def replayed(generator, shapes, device):
        assert [tuple(s) for s in shapes] == [(batch, 3)]
        return (torch.from_numpy(draws.pop(0)),)

    monkeypatch.setattr(tloops, "draw_noise", replayed)
    tloss = ttrain.train_pf_measurement(tbuddy, tm, tds, epochs=1, batch_size=batch)
    assert not draws
    _assert_same_training(jm, tm, jbuddy, tbuddy, start, jloss, tloss)
