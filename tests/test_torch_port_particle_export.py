"""Pipelined serving bundles of grids with a particle axis, in gloo worlds of
CPU ranks: the port's counterpart of the JAX package's export of the
shard-mapped pipelined program over a data x pipe x particle grid (its
``experiments/export.py:138-180``). The door crossmodal PF at full width,
JAX's seeded weights, N = 4, T = 8, M = 16, as in
``test_torch_port_multidevice_export.py``.

The bundle's chunk program holds the particle-sharded step's collectives
(functional collectives traced into the graph); loaded on every rank, it
replays the live pipelined model from the same seed bit for bit. The live
loop itself, through the same functional collectives, is held against the
JAX package's pipe x particle loop on its per-shard draws."""

import dataclasses
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crossmodal import door_models as jdoor
from multimodalfilter_tpu.parallel.mesh import create_mesh as jax_create_mesh
from multimodalfilter_tpu.parallel.temporal_pipeline import make_pipelined_pf_loop
from multimodalfilter_tpu.types import ParticleBelief as JaxBelief
from multimodalfilter_tpu_torch.parallel.launch import spawn

sys.path.insert(0, "tests")
import test_torch_port_dist_worker as worker  # noqa: E402
import test_torch_port_multidevice as four  # noqa: E402

T, N, M, D = four.T, four.N, four.M, four.D
# (axes, shape, the JAX grid's data rows): pipe x particle, and the full grid.
GRIDS = {"pipe_particle": (("pipe", "particle"), (2, 2), 1),
         "data_pipe_particle": (("data", "pipe", "particle"), (2, 2, 2), 2)}


def _pipelined_draws(key, t, n, m, shards, data_rows):
    """What JAX's pipelined loop with a particle axis draws (micro 1, no
    microbatch fold; temporal_pipeline.py:150-163, 330-345), assembled into
    the global (T, N*M, D) noise and (T, N) offsets: the plain loop's T
    keys, each folded with the data index on a grid with a data axis, then
    the particle-sharded step's (k_noise, k_resample), the noise folded with
    the shard."""
    n_loc, mp = n // data_rows, m // shards
    eps = np.zeros((t, n, m, D), np.float32)
    u0 = np.zeros((t, n), np.float32)
    for i, key_t in enumerate(jax.random.split(key, t)):
        for row in range(data_rows):
            k = jax.random.fold_in(key_t, row) if data_rows > 1 else key_t
            k_noise, k_resample = jax.random.split(k)
            rows = slice(row * n_loc, (row + 1) * n_loc)
            u0[i, rows] = np.asarray(jax.random.uniform(k_resample, (n_loc, 1)))[:, 0]
            for q in range(shards):
                draw = jax.random.normal(jax.random.fold_in(k_noise, q), (n_loc * mp, D))
                eps[i, rows, q * mp:(q + 1) * mp] = np.asarray(draw).reshape(n_loc, mp, D)
    return eps.reshape(t, n * m, D), u0


@pytest.fixture(scope="module", params=sorted(GRIDS))
def world(request, tmp_path_factory):
    """One world a grid, its ranks run while this process computes JAX's
    pipelined loop (micro 1, no microbatch fold) on the same grid."""
    name = request.param
    axes, shape, data_rows = GRIDS[name]
    jm = jdoor.DoorCrossmodalParticleFilter()
    obs, controls = worker.sequences(T, N, seed=3)
    r = np.random.default_rng(4)
    key = jax.random.PRNGKey(7)
    belief = (r.normal(size=(N, M, D)).astype(np.float32),
              np.full((N, M), -np.log(M), np.float32))
    inputs = {"params": four._numpy_state(jm.params), "obs": obs, "controls": controls,
              "mean": (0.3 * r.normal(size=(N, D))).astype(np.float32),
              "cov": np.tile(np.eye(D, dtype=np.float32) * 0.1, (N, 1, 1)),
              "m": M, "axes": axes, "shape": shape, "belief": belief,
              "particle_draws": _pipelined_draws(key, T, N, M, 2, data_rows),
              "work": str(tmp_path_factory.mktemp(f"particle_bundles_{name}"))}
    ranks = {}
    thread = threading.Thread(target=lambda: ranks.setdefault("out", spawn(
        worker.export_particle_rank_cases, int(np.prod(shape)), "cpu", inputs,
        timeout_s=240)))
    thread.start()
    try:
        defn = dataclasses.replace(jm.definition, num_particles_eval=M)
        loop = make_pipelined_pf_loop(
            defn, jax_create_mesh(int(np.prod(shape)), axes, shape=shape), num_microbatches=1,
            fold_microbatch_key=False, particle_axis_name="particle",
            data_axis_name="data" if "data" in axes else None)
        _, est = loop(jm.params, JaxBelief(*map(jnp.asarray, belief)),
                      jax.tree_util.tree_map(jnp.asarray, obs), jnp.asarray(controls), key)
        jax_est = np.asarray(est)
    finally:
        thread.join()
    assert "out" in ranks, "the world failed (its error is above)"
    return {"name": name, "ranks": ranks["out"], "jax": jax_est}


def test_bundle_replays_the_live_pipeline_on_every_rank(world):
    """Estimates and the final belief (particles and log-weights) of the
    bundle are the live pipelined model's bit for bit on every rank, and the
    same on every rank; the meta records the particle axis beside the
    others; the bundle counts the collectives the live loop counts."""
    axes, shape, _ = GRIDS[world["name"]]
    for rank in world["ranks"]:
        case = rank["grid"]
        meta = case["meta"]
        assert meta["axes"] == list(axes) and meta["shape"] == list(shape)
        assert meta["particle_axis"] == "particle" and meta["pipe_axis"] == "pipe"
        assert meta["data_axis"] == ("data" if "data" in axes else None)
        assert meta["stages"] == 2 and meta["microbatches"] == 2
        assert set(meta["groups"]) == {"particle"}
        steps = T // 2
        assert sorted(meta["collectives"]) == [["all_gather", "particle", steps],
                                               ["all_reduce_max", "particle", steps],
                                               ["all_reduce_sum", "particle", steps]]
        assert case["served"].shape == (T, N, D)
        torch.testing.assert_close(case["served"], case["live"], rtol=0, atol=0)
        for live, served in zip(*case["belief"]):
            assert served.shape == live.shape == (N, M) + live.shape[2:]
            torch.testing.assert_close(served, live, rtol=0, atol=0)
        for op in ("all_reduce_max", "all_reduce_sum"):
            assert case["served_counts"][(op, "particle")] == T == \
                case["live_counts"][(op, "particle")]
        torch.testing.assert_close(case["served"], world["ranks"][0]["grid"]["served"],
                                   rtol=0, atol=0)


def test_ragged_time_and_an_altered_group_name_raise(world):
    """T = 7 over 2 stages does not export; a bundle whose meta records
    another name for the particle axis's group raises on load, naming the
    axis."""
    for rank in world["ranks"]:
        assert rank["ragged"] is not None and "divisible by the stage count" in rank["ragged"]
        assert rank["altered"] is not None and "'particle' axis" in rank["altered"]


def test_live_loop_matches_the_jax_pipelined_loop(world):
    """The live pipe x particle loop (micro 1), its collectives the
    functional ones, against JAX's make_pipelined_pf_loop with a particle
    axis on the same per-shard draws, on every rank."""
    for rank in world["ranks"]:
        four._scale_close(rank["live_micro1"].numpy(), world["jax"], four.EST_RTOL,
                          world["name"])
