"""The port's multi-device paths in a world of four CPU ranks (gloo), held
against the JAX package's ``parallel/`` on its 8-device virtual CPU mesh
and against the port's own single-device loops.

One world runs every case (``test_torch_port_dist_worker.four_rank_cases``)
while this process computes the JAX references; each test reads its part.
The door crossmodal PF is at full width (units 64) with JAX's seeded
weights, at N = 4 trajectories, T = 8 steps, M = 16 particles (8 in
training). The PF's random numbers are pre-drawn: JAX's own draws (its
per-shard folds for the particle-sharded loop, its plain loop's draws for
the pipeline, its epoch keys for training), so the two frameworks consume
the same noise.
"""

import dataclasses
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crossmodal import door_models as jdoor
from multimodalfilter_tpu import train as jtrain
from multimodalfilter_tpu.data import SubsequenceDataset as JaxSubsequenceDataset
from multimodalfilter_tpu.experiments import Buddy as JaxBuddy
from multimodalfilter_tpu.filtering.wrappers import freeze_module as jax_freeze
from multimodalfilter_tpu.parallel.mesh import create_mesh as jax_create_mesh
from multimodalfilter_tpu.parallel.particle_sharding import make_particle_sharded_pf_loop
from multimodalfilter_tpu.parallel.temporal_pipeline import make_pipelined_pf_loop
from multimodalfilter_tpu.types import ParticleBelief as JaxBelief
from multimodalfilter_tpu.types import Trajectory as JaxTrajectory
from multimodalfilter_tpu_torch.crossmodal import door_models as tdoor
from multimodalfilter_tpu_torch.parallel.launch import spawn
from multimodalfilter_tpu_torch.types import ParticleBelief
from multimodalfilter_tpu_torch.weights import params_from_jax

sys.path.insert(0, "tests")
import test_torch_port_dist_worker as worker  # noqa: E402

T, N, M, D = 8, 4, 16, 3
# Estimates of loops on the same draws, fp32 nets at full width: sums in
# another order (a batch split over ranks, encoders over fewer frames, two
# frameworks) compound over the T steps of the recursion. Relative to the
# estimates' scale.
EST_RTOL = 1e-5
# A resampled particle set, where the same indices are drawn: the particles
# themselves carry the same fp32 differences.
PARTICLE_ATOL = 1e-5
# Gradients of the e2e loss, per parameter relative to its largest entry:
# the same sums split over ranks or time chunks and added in another order.
GRAD_RTOL = 1e-4
LOSS_RTOL = 1e-5
# After a train_e2e epoch of 2 Adam steps, each parameter's update in
# relative L2 norm: against JAX as tests/test_torch_port_train_e2e.py holds
# the single-device epoch (an entry whose gradient is within fp32 sum-order
# noise of zero steps by O(lr) differently; measured 3.4e-2 there), and
# against the port on one device (the same noise from another sum order).
JAX_UPDATE_RTOL = 1e-1
UPDATE_RTOL = 1e-2


def _scale_close(got, want, rtol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-12)
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, f"{what}: max error {err:.3g} over scale {scale:.3g}"


def _numpy_state(jax_params):
    """A flax param tree as the port's state dict of numpy arrays."""
    return {k: v.numpy() for k, v in
            params_from_jax(jax.tree_util.tree_map(np.array, jax_params)).items()}


def _particle_draws(key, t, n, m, shards, data_rows=1):
    """What JAX's particle-sharded eval loop draws (particle_sharding.py
    :106-:115, :199), assembled into the global (T, N*M, D) noise and (T, N)
    offsets: a per-row-block key folded with the data index on a 2-D mesh,
    then per step (k_noise, k_resample), the noise folded with the shard."""
    n_loc, mp = n // data_rows, m // shards
    eps = np.zeros((t, n, m, D), np.float32)
    u0 = np.zeros((t, n), np.float32)
    for row in range(data_rows):
        row_key = jax.random.fold_in(key, row) if data_rows > 1 else key
        for i, key_t in enumerate(jax.random.split(row_key, t)):
            k_noise, k_resample = jax.random.split(key_t)
            rows = slice(row * n_loc, (row + 1) * n_loc)
            u0[i, rows] = np.asarray(jax.random.uniform(k_resample, (n_loc, 1)))[:, 0]
            for q in range(shards):
                draw = jax.random.normal(jax.random.fold_in(k_noise, q), (n_loc * mp, D))
                eps[i, rows, q * mp:(q + 1) * mp] = np.asarray(draw).reshape(n_loc, mp, D)
    return eps.reshape(t, n * m, D), u0


def _loop_draws(key, t, n, m):
    """JAX forward_loop's pre-draw (pf.py): T keys, each split; normal
    (N*M, D) and uniform (N, M)."""
    pairs = jax.vmap(jax.random.split)(jax.random.split(key, t))
    eps = jax.vmap(lambda k: jax.random.normal(k, (n * m, D)))(pairs[:, 0])
    uni = jax.vmap(lambda k: jax.random.uniform(k, (n, m)))(pairs[:, 1])
    return np.array(eps), np.array(uni)


DP = {"m": 4, "batch": 8, "seq_len": 3, "count": 8, "seed": 3}


def _epoch_noise(rng, num_batches):
    """One JAX _run_epochs epoch's draws: root._next_key(), split per batch,
    then the e2e loss's (k_init, k_loop) draws."""
    _, key = jax.random.split(rng)
    out = []
    for k in jax.random.split(key, num_batches):
        k_init, k_loop = jax.random.split(k)
        eps0 = jax.random.normal(k_init, (DP["batch"], DP["m"], D))
        pairs = jax.vmap(jax.random.split)(jax.random.split(k_loop, DP["seq_len"] - 1))
        eps_seq = jax.vmap(lambda kk: jax.random.normal(kk, (DP["batch"] * DP["m"], D)))(
            pairs[:, 0])
        out.append((np.array(eps0), np.array(eps_seq)))
    return out


def _jax_references(jm, inputs, tmp_path):
    """JAX's particle-sharded loops (Q = 4; Q = 2 on a (2, 2) data x
    particle mesh), its pipelined loop (4 stages, micro 1, no fold: its
    plain loop) and its data-parallel epoch (make_sharded_epoch_fn on 4
    devices); the epoch compiles in a thread of its own beside the loops."""
    defn = dataclasses.replace(jm.definition, num_particles_eval=M)
    params = jm.params  # the epoch below trains jm from these
    out = {}
    epoch = threading.Thread(target=_jax_epoch, args=(jm, tmp_path, out))
    epoch.start()
    try:
        obs = jax.tree_util.tree_map(jnp.asarray, inputs["obs"])
        ctrl = jnp.asarray(inputs["controls"])
        belief = JaxBelief(*map(jnp.asarray, inputs["belief"]))
        for name, mesh, data_axis in (
                ("q4", jax_create_mesh(4, ("particle",)), None),
                ("data_q2", jax_create_mesh(4, ("data", "particle"), shape=(2, 2)), "data")):
            loop = make_particle_sharded_pf_loop(defn, mesh, data_axis_name=data_axis)
            final, est = loop(params, belief, obs, ctrl, inputs["key"])
            out[name] = {"est": np.asarray(est), "particles": np.asarray(final.particles)}
        loop = make_pipelined_pf_loop(defn, jax_create_mesh(4, ("pipe",)), num_microbatches=1,
                                      fold_microbatch_key=False)
        _, est = loop(params, belief, obs, ctrl, inputs["key"])
        out["pipe"] = np.asarray(est)
    finally:
        epoch.join()
    assert "dp_params" in out, "JAX's data-parallel epoch failed (its error is above)"
    return out


def _jax_epoch(jm, tmp_path, out):
    """JAX's train_e2e(mesh=...) epoch: make_sharded_epoch_fn on 4 devices,
    the gate frozen."""
    jm.definition = dataclasses.replace(jm.definition, num_particles_train=DP["m"])
    jax_freeze(jm.measurement_model.crossmodal_weight_model)
    jbuddy = JaxBuddy("dp", jm, checkpoint_dir=str(tmp_path / "jc"),
                      metadata_dir=str(tmp_path / "jm"), log_dir=str(tmp_path / "jl"),
                      verbose=False)
    dataset = JaxSubsequenceDataset(
        worker.trajectories(DP["count"], DP["seq_len"] * 2, DP["seed"], JaxTrajectory),
        DP["seq_len"])
    out["dp_loss"] = jtrain.train_e2e(jbuddy, jm, dataset, epochs=1, batch_size=DP["batch"],
                                      mesh=jax_create_mesh(4))
    out["dp_params"] = params_from_jax(jax.tree_util.tree_map(np.asarray, jm.params))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp_path = tmp_path_factory.mktemp("multidevice")
    jm = jdoor.DoorCrossmodalParticleFilter()
    obs, controls = worker.sequences(T, N, seed=0)
    r = np.random.default_rng(1)
    key = jax.random.PRNGKey(42)
    n_batches = DP["count"] * 2 // DP["batch"]
    inputs = {
        "params": _numpy_state(jm.params), "obs": obs, "controls": controls, "key": key,
        "belief": (r.normal(size=(N, M, D)).astype(np.float32),
                   np.full((N, M), -np.log(M), np.float32)),
        "mean": (0.3 * r.normal(size=(N, D))).astype(np.float32),
        "cov": np.tile(np.eye(D, dtype=np.float32) * 0.1, (N, 1, 1)),
        "particle_draws": {"q4": _particle_draws(key, T, N, M, 4),
                           "data_q2": _particle_draws(key, T, N, M, 2, data_rows=2)},
        "loop_draws": _loop_draws(key, T, N, M),
        "dp": {**DP, "logs": str(tmp_path / "logs"),
               "draws": _epoch_noise(jm._rng, n_batches)},
    }
    ranks = {}
    thread = threading.Thread(target=lambda: ranks.setdefault("out", spawn(
        worker.four_rank_cases, 4, "cpu", {k: v for k, v in inputs.items() if k != "key"},
        timeout_s=240)))
    thread.start()
    try:
        jax_out = _jax_references(jm, inputs, tmp_path)
    finally:
        thread.join()
    assert "out" in ranks, "the world of 4 ranks failed (its error is above)"
    # The port's plain loop on the pipeline's draws, for the pipeline cases.
    model = worker.door_pf(inputs["params"])
    with torch.no_grad():
        _, plain = model.definition.forward_loop(
            ParticleBelief(*worker.tensors(inputs["belief"])), worker.tensors(obs),
            torch.from_numpy(controls), train=False, enabled=(True, True),
            eps_seq=torch.from_numpy(inputs["loop_draws"][0]),
            uniforms_seq=torch.from_numpy(inputs["loop_draws"][1]))
    return {"ranks": ranks["out"], "jax": jax_out, "plain": plain.numpy(), "inputs": inputs}


@pytest.mark.parametrize("name", ["q4", "data_q2"])
def test_particle_sharded_eval_matches_jax(world, name):
    """Q = 4, and Q = 2 on the data x particle grid: the estimates and the
    resampled particles (so the indices drawn) of JAX's
    make_particle_sharded_pf_loop on the same per-shard noise and u0; the
    final weights normalised over all M; per step one max and one sum
    all-reduce and one all-gather on the particle axis."""
    got, want = world["ranks"][0][name], world["jax"][name]
    _scale_close(got["est"], want["est"], EST_RTOL, f"{name} estimates")
    np.testing.assert_allclose(got["particles"].numpy(), want["particles"],
                               atol=PARTICLE_ATOL, rtol=0)
    np.testing.assert_allclose(torch.logsumexp(got["log_w"], 1).numpy(), 0.0, atol=1e-5)
    assert got["counts"] == {("all_reduce_max", "particle"): T,
                             ("all_reduce_sum", "particle"): T,
                             ("all_gather", "particle"): T + 2,
                             **({("all_gather", "data"): 3} if name == "data_q2" else {})}
    for rank in world["ranks"][1:]:
        torch.testing.assert_close(rank[name]["est"], got["est"], rtol=0, atol=0)


def test_sharded_systematic_resampling_offspring_counts(world):
    """With u0 the same on every rank, each particle i of a row has
    floor(M w_i) or ceil(M w_i) offspring, and the new log-weights are
    -log M. With u0 drawn per rank (the fault a shared offset prevents) the
    counts break it."""
    out = world["ranks"][0]
    w = out["offspring_weights"].double().numpy()
    m = w.shape[1]

    def within(picked):
        counts = np.stack([np.bincount(row.long().numpy(), minlength=m) for row in picked])
        return (counts >= np.floor(m * w - 1e-4)) & (counts <= np.ceil(m * w + 1e-4))

    assert within(out["offspring_shared"]).all()
    np.testing.assert_allclose(out["offspring_shared_lw"].numpy(), -np.log(m), rtol=1e-6)
    assert not within(out["offspring_per_rank"]).all()


@pytest.mark.parametrize("case", ["pipe4_micro1", "pipe4_micro2", "pipe4_micro4",
                                  "data_pipe_micro2"])
def test_pipelined_loop_matches_the_plain_loop(world, case):
    """The PF loop over 4 stages at micro 1, 2 and 4, and on the data x
    pipe grid: the plain loop's estimates on the same global noise, JAX's
    pipelined loop (micro 1, no key fold: its plain loop), and the final
    belief the same on every rank."""
    final, est = world["ranks"][0][case]
    _scale_close(est.numpy(), world["plain"], EST_RTOL, f"{case} vs the plain loop")
    _scale_close(est.numpy(), world["jax"]["pipe"], EST_RTOL, f"{case} vs JAX")
    for rank in world["ranks"][1:]:
        torch.testing.assert_close(rank[case][0].particles, final.particles, rtol=0, atol=0)
        torch.testing.assert_close(rank[case][1], est, rtol=0, atol=0)


@pytest.mark.parametrize("micro", [1, 2])
def test_pipe_x_particle_matches_the_particle_sharded_loop(world, micro):
    """The pipe x particle grid (2 x 2) on the same per-shard noise and u0
    as the data x particle run (Q = 2): its estimates, so JAX's."""
    _, est = world["ranks"][0][f"pipe_particle_micro{micro}"]
    _scale_close(est.numpy(), world["jax"]["data_q2"]["est"], EST_RTOL, "pipe x particle")


def test_facade_pads_time_to_the_stages(world):
    """T = 7 over 4 stages: the facade pads to 8 and drops the padded
    estimate; the first 7 steps are the plain loop's. The loop's cache key
    carries the layout."""
    est = world["ranks"][0]["padded"]
    assert est.shape == (T - 1, N, D)
    _scale_close(est.numpy(), world["plain"][:T - 1], EST_RTOL, "padded pipeline")
    layout = world["ranks"][0]["padded_key"]
    assert layout.pipe_axis == "pipe" and layout.micro == 2 and layout.mesh[0] == ("pipe",)


@pytest.mark.parametrize("name", ["DoorKalmanFilter", "DoorCrossmodalKalmanFilter",
                                  "DoorLSTMFilter"])
def test_generic_pipelined_loop(world, name):
    """The EKF, the crossmodal KF and the LSTM over 4 stages, 2
    microbatches: their own plain loop's estimates and final belief."""
    (b_ref, e_ref), (b_got, e_got) = world["ranks"][0][f"generic_{name}"]
    _scale_close(e_got.numpy(), e_ref.numpy(), EST_RTOL, name)
    for got, want in zip(torch.utils._pytree.tree_leaves(b_got),
                         torch.utils._pytree.tree_leaves(b_ref)):
        _scale_close(got.numpy(), want.numpy(), EST_RTOL, f"{name} belief")


@pytest.mark.parametrize("name", ["dp4", "pipe4", "data_pipe", "pipe_particle", "particle4"])
def test_sharded_bptt_gradients_match_the_plain_bptt(world, name):
    """BPTT through 4 steps: data-parallel over 4, pipelined over 4 stages,
    the data x pipe and pipe x particle grids and the particle axis alone
    (Q = 4): the loss and every gradient of the plain BPTT, reduced by one
    all-reduce over the mesh. A gradient off by a factor of a mesh axis, or
    missing a part, would show here."""
    loss_ref, grads_ref = world["ranks"][0]["bptt_plain"]
    for rank in world["ranks"]:
        loss, grads = rank[f"bptt_{name}"]
        np.testing.assert_allclose(loss, loss_ref, rtol=LOSS_RTOL)
        for k, g in grads_ref.items():
            _scale_close(grads[k].numpy(), g.numpy(), GRAD_RTOL, f"{name} {k}")
    counts = world["ranks"][0][f"bptt_{name}_counts"]
    assert counts[("all_reduce_sum", "mesh")] == 1
    if name in ("pipe4", "data_pipe", "pipe_particle"):
        assert counts[("relay", "pipe")] == 2  # rank 0, stage 0: one per microbatch


def test_data_parallel_epoch_matches_one_device_and_jax(world):
    """train_e2e over a 4-wide data axis, 2 steps of batch 8 with the gate
    frozen: the one-device port epoch's gradients, losses and parameters,
    JAX's make_sharded_epoch_fn on 4 devices (its train_e2e(mesh=...)),
    the frozen gate bitwise unchanged, the parameters the same on every
    rank, and one gradient all-reduce per optimizer step."""
    ranks = [r["dp_train"] for r in world["ranks"]]
    dp, single = ranks[0]["mesh"], ranks[0]["single"]
    start = worker.tensors(world["inputs"]["params"])
    assert dp["left"] == single["left"] == 0 and dp["steps"] == single["steps"] == 2
    assert dp["counts"] == {("all_reduce_sum", "mesh"): 2, ("broadcast", "mesh"): 1}
    np.testing.assert_allclose(dp["loss"], single["loss"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(dp["loss"], world["jax"]["dp_loss"], rtol=LOSS_RTOL)
    for step_dp, step_single in zip(dp["grads"], single["grads"]):
        for k, g in step_single.items():
            _scale_close(step_dp[k].numpy(), g.numpy(), GRAD_RTOL, f"step gradient {k}")
    for k, v in dp["params"].items():
        for other in ranks[1:]:
            assert torch.equal(other["mesh"]["params"][k], v), k
        if k.startswith("measurement_model.crossmodal_weight_model."):
            assert torch.equal(v, start[k]), f"frozen {k} moved"
            continue
        want = world["jax"]["dp_params"][k] - start[k]
        for ref, rtol, what in ((single["params"][k] - start[k], UPDATE_RTOL, "one device"),
                                (want, JAX_UPDATE_RTOL, "JAX")):
            rel = float((v - start[k] - ref).norm() / ref.norm())
            assert rel <= rtol, f"{k}: update differs from {what} by {rel:.3g} of its norm"
