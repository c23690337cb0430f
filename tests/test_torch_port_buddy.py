"""The port's checkpoints, metadata and the rest of the facade against the
JAX package on the CPU.

- ``Buddy``: save and load round trips (labelled, and the latest-checkpoint
  fallback) give the same parameters bit for bit and the same Adam state;
  ``load_checkpoint_module`` moves only its subtree; metadata persists;
  ``_optimizer_dict.clear()`` drops stashed optimizer states, and a stashed
  state warm-starts ``get_named_optimizer``; a JAX checkpoint (msgpack, read
  with flax) converts through ``weights.params_from_jax`` to what
  ``load_jax_params`` loads.
- ``StatefulFilter``: ``forward`` with given draws against JAX's ``forward``,
  ``know_image_blackout`` set after construction, ``num_parameters``.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from crossmodal import door_models as jdoor
from multimodalfilter_tpu.experiments import Buddy as JaxBuddy
from multimodalfilter_tpu.types import ParticleBelief as JaxBelief
from multimodalfilter_tpu_torch.crossmodal import door_models as tdoor
from multimodalfilter_tpu_torch.experiments import Buddy
from multimodalfilter_tpu_torch.train import optim
from multimodalfilter_tpu_torch.types import ParticleBelief
from multimodalfilter_tpu_torch.weights import params_from_jax

@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small ops on one thread each, so that a machine busy with other test
    workers does not stall them on an oversubscribed thread pool. Restored
    after the module."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _buddy(tmp_path, name, model=None):
    return Buddy(name, model, checkpoint_dir=str(tmp_path / "checkpoints"),
                 metadata_dir=str(tmp_path / "metadata"), log_dir=str(tmp_path / "logs"),
                 verbose=False)


def _trained(tmp_path, name="run", seed=0):
    """A model, its buddy and a named Adam that has taken two steps."""
    model = tdoor.DoorUnimodalParticleFilter(device="cpu", seed=seed)
    buddy = _buddy(tmp_path, name, model)
    opt = optim.get_named_optimizer(buddy, "e2e", model.params, learning_rate=3e-4)
    g = torch.Generator().manual_seed(seed)
    for _ in range(2):
        for p in model.params.parameters():
            p.grad = torch.randn(p.shape, generator=g)
        opt.step()
        buddy.increment_steps()
    return model, buddy, opt


def _assert_state_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


def _assert_adam_equal(a, b):
    sa, sb = a.state_dict(), b.state_dict()
    assert sa["param_groups"] == sb["param_groups"]
    assert sa["state"].keys() == sb["state"].keys()
    for i in sa["state"]:
        for k, v in sa["state"][i].items():
            assert torch.equal(v, sb["state"][i][k]), (i, k)


@pytest.mark.parametrize("label", ["phase_2", None], ids=["labelled", "latest"])
def test_checkpoint_round_trip(tmp_path, label):
    model, buddy, opt = _trained(tmp_path)
    if label is None:
        # Two checkpoints; the fallback reads the newer one.
        old = buddy.save_checkpoint("older")
        os.utime(old, (1, 1))
    path = buddy.save_checkpoint(label)
    assert path.endswith(".pt") and os.path.exists(path)

    fresh = tdoor.DoorUnimodalParticleFilter(device="cpu", seed=9)
    loader = _buddy(tmp_path, "run", fresh)
    existing = optim.get_named_optimizer(loader, "e2e", fresh.params, learning_rate=3e-4)
    loader.load_checkpoint(label=label)
    _assert_state_equal(model.params.state_dict(), fresh.params.state_dict())
    assert loader.optimizer_steps == 2
    _assert_adam_equal(opt, existing)

    # An optimizer created after the load warm-starts from its stash.
    late = tdoor.DoorUnimodalParticleFilter(device="cpu", seed=8)
    late_buddy = _buddy(tmp_path, "run", late)
    late_buddy.load_checkpoint(label=label)
    warm = optim.get_named_optimizer(late_buddy, "e2e", late.params, learning_rate=3e-4)
    _assert_adam_equal(opt, warm)
    assert late_buddy._pending_optimizer_state == {}


def test_load_checkpoint_module_moves_only_its_subtree(tmp_path):
    source, buddy, _ = _trained(tmp_path, "src", seed=0)
    buddy.save_checkpoint("a")
    target = tdoor.DoorUnimodalParticleFilter(device="cpu", seed=5)
    before = {k: v.clone() for k, v in target.params.state_dict().items()}
    loader = _buddy(tmp_path, "dst", target)
    loader.load_checkpoint_module("dynamics_model", label="a", experiment_name="src")
    src = source.params.state_dict()
    for k, v in target.params.state_dict().items():
        expected = src[k] if k.startswith("dynamics_model.") else before[k]
        assert torch.equal(v, expected), k
    with pytest.raises(KeyError, match="no parameters"):
        loader.load_checkpoint_module("measurement_model.measurement_models.0",
                                      target="measurement_model.measurement_models.1",
                                      label="a", experiment_name="src")
    with pytest.raises(FileNotFoundError):
        loader.load_checkpoint(label="missing")


def test_metadata_is_persisted(tmp_path):
    buddy = _buddy(tmp_path, "meta")
    assert buddy.metadata == {}
    buddy.set_metadata({"model_type": "DoorParticleFilter", "dataset_args": {"a": 1}})
    buddy.add_metadata({"eval_results_stats": {"x_rmse_cm_mean": 1.5}})
    again = _buddy(tmp_path, "meta")
    assert again.metadata == {"model_type": "DoorParticleFilter", "dataset_args": {"a": 1},
                              "eval_results_stats": {"x_rmse_cm_mean": 1.5}}


def test_optimizer_dict_clear_drops_stashed_states(tmp_path):
    model, buddy, _ = _trained(tmp_path, "clear")
    buddy.save_checkpoint("c")
    other = tdoor.DoorUnimodalParticleFilter(device="cpu", seed=2)
    loader = _buddy(tmp_path, "clear", other)
    loader.load_checkpoint("c")
    assert set(loader._pending_optimizer_state) == {"e2e"}
    loader._optimizer_dict.clear()
    assert loader._pending_optimizer_state == {}
    fresh = optim.get_named_optimizer(loader, "e2e", other.params)
    assert fresh.state_dict()["state"] == {}


@pytest.fixture(scope="module")
def jax_model():
    return jdoor.DoorCrossmodalParticleFilter()


@pytest.fixture()
def models(jax_model, monkeypatch):
    """The JAX crossmodal PF (its definition and belief restored after the
    test) and a port model with its weights."""
    for name in ("definition", "_belief", "_training"):
        monkeypatch.setattr(jax_model, name, getattr(jax_model, name))
    tm = tdoor.DoorCrossmodalParticleFilter(device="cpu")
    tm.load_jax_params(jax_model.params)
    return jax_model, tm


def test_jax_checkpoint_converts_to_load_jax_params(tmp_path, models):
    jm, tm = models
    path = JaxBuddy("jax", jm, checkpoint_dir=str(tmp_path / "c"),
                    metadata_dir=str(tmp_path / "m"), log_dir=str(tmp_path / "l"),
                    verbose=False).save_checkpoint("phase")
    with open(path, "rb") as f:
        state = serialization.msgpack_restore(f.read())
    converted = params_from_jax(state["params"])
    _assert_state_equal(converted, tm.params.state_dict())


def test_forward_with_given_draws_matches_jax(models):
    jm, tm = models
    jm.eval()
    tm.eval()
    assert not tm.training and tm.training == jm.training
    n, m = 2, 300
    r = np.random.default_rng(0)
    obs = {"image": r.normal(size=(n, 32, 32)).astype(np.float32),
           "gripper_pos": r.normal(size=(n, 3)).astype(np.float32),
           "gripper_sensors": r.normal(size=(n, 7)).astype(np.float32)}
    controls = r.normal(size=(n, 7)).astype(np.float32)
    particles = (0.3 * r.normal(size=(n, m, 3))).astype(np.float32)
    lw = np.full((n, m), -np.log(m), np.float32)
    jm.belief = JaxBelief(jnp.asarray(particles), jnp.asarray(lw))
    tm.belief = ParticleBelief(torch.from_numpy(particles), torch.from_numpy(lw))
    key = jm._rng
    est_j = np.asarray(jm.forward(observations=obs, controls=controls))
    # The facade's next key, split as the PF step splits it.
    _, step_key = jax.random.split(key)
    k_noise, k_resample = jax.random.split(step_key)
    eps = np.array(jax.random.normal(k_noise, (n * m, 3)))
    uni = np.array(jax.random.uniform(k_resample, (n, m)))
    est_t = tm.forward(observations=obs, controls=controls, eps=eps, uniforms=uni)
    np.testing.assert_allclose(est_t.numpy(), est_j, atol=1e-5, rtol=0)
    assert tm.belief.particles.shape == (n, m, 3)
    np.testing.assert_allclose(tm.belief.log_weights.numpy(),
                               np.asarray(jm.belief.log_weights), atol=1e-6, rtol=0)


def test_know_image_blackout_set_after_construction_matches_jax(models):
    jm, tm = models
    params = tm.params
    assert tm.know_image_blackout is jm.know_image_blackout is False
    jm.know_image_blackout = True
    tm.know_image_blackout = True
    assert tm.know_image_blackout is jm.know_image_blackout is True
    assert tm.params is params  # the networks are kept

    r = np.random.default_rng(1)
    obs = {"image": r.normal(size=(3, 32, 32)).astype(np.float32),
           "gripper_pos": r.normal(size=(3, 3)).astype(np.float32),
           "gripper_sensors": r.normal(size=(3, 7)).astype(np.float32)}
    obs["image"][1] = 0.0  # a blacked-out frame
    jgate = jm.definition.measurement_model.crossmodal_weight_model
    jlw = np.asarray(jgate.log_weights(
        jm.params["measurement_model"]["crossmodal_weight_model"], obs))
    with torch.no_grad():
        tlw = tm.definition.measurement_model.crossmodal_weight_model.log_weights(
            {k: torch.from_numpy(v) for k, v in obs.items()}).numpy()
    assert tlw[1, 0] < -1e8 and tlw[0, 0] > -1e8
    np.testing.assert_allclose(tlw, jlw, atol=1e-4, rtol=1e-6)


@pytest.mark.parametrize("cls", ["DoorCrossmodalParticleFilter", "DoorParticleFilter"])
def test_num_parameters_matches_jax(cls, jax_model):
    jm = jax_model if cls == type(jax_model).__name__ else getattr(jdoor, cls)()
    assert getattr(tdoor, cls)(device="cpu").num_parameters() == jm.num_parameters()


def test_device_is_the_models_or_the_entry_points(tmp_path, monkeypatch):
    """With a model, its parameters' device (JAX's Buddy.device is its
    first device: the CPU here too). Without one, the device the entry
    points choose: the CPU when asked; cuda:0 by default, and where CUDA is
    missing a RuntimeError, never a quiet CPU."""
    model = tdoor.DoorUnimodalParticleFilter(device="cpu")
    jax_device = JaxBuddy("jax_device", None, checkpoint_dir=str(tmp_path / "c"),
                          metadata_dir=str(tmp_path / "m"), log_dir=str(tmp_path / "l"),
                          verbose=False).device
    assert _buddy(tmp_path, "with_model", model).device == torch.device("cpu")
    assert jax_device.platform == "cpu"
    asked = Buddy("asked", None, checkpoint_dir=str(tmp_path / "c"),
                  metadata_dir=str(tmp_path / "m"), log_dir=str(tmp_path / "l"),
                  device="cpu", verbose=False)
    assert asked.device == torch.device("cpu")
    asked.attach_model(model)
    assert asked.device == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _buddy(tmp_path, "default", None).device
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    assert _buddy(tmp_path, "default", None).device == torch.device("cuda", 0)
