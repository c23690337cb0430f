"""The full (data, pipe, particle) grid in a world of eight CPU ranks
(gloo): the eval loop and BPTT on a 2 x 2 x 2 mesh, the JAX package's
3-D grid (``make_pipelined_pf_loop(data_axis_name=..., particle_axis_name=...)``).

The grid's eval loop is held against JAX's data x particle loop on JAX's
per-shard draws (the pipe axis adds no draws: with one microbatch per
stage the grid runs the same steps in time chunks), and its BPTT against
the port's plain BPTT. The door crossmodal PF at full width with JAX's
seeded weights, N = 4, T = 8, M = 16 (8 in training).
"""

import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from crossmodal import door_models as jdoor
from multimodalfilter_tpu.parallel.mesh import create_mesh as jax_create_mesh
from multimodalfilter_tpu.parallel.particle_sharding import make_particle_sharded_pf_loop
from multimodalfilter_tpu.types import ParticleBelief as JaxBelief
from multimodalfilter_tpu_torch.parallel.launch import spawn

sys.path.insert(0, "tests")
import test_torch_port_dist_worker as worker  # noqa: E402
import test_torch_port_multidevice as four  # noqa: E402

T, N, M, D = four.T, four.N, four.M, four.D


@pytest.fixture(scope="module")
def world():
    jm = jdoor.DoorCrossmodalParticleFilter()
    obs, controls = worker.sequences(T, N, seed=0)
    r = np.random.default_rng(1)
    key = jax.random.PRNGKey(42)
    belief = (r.normal(size=(N, M, D)).astype(np.float32),
              np.full((N, M), -np.log(M), np.float32))
    inputs = {"params": four._numpy_state(jm.params),
              "obs": obs, "controls": controls, "belief": belief,
              "draws": four._particle_draws(key, T, N, M, 2, data_rows=2)}
    ranks = spawn(worker.eight_rank_cases, 8, "cpu", inputs, timeout_s=240)
    defn = dataclasses.replace(jm.definition, num_particles_eval=M)
    loop = make_particle_sharded_pf_loop(
        defn, jax_create_mesh(4, ("data", "particle"), shape=(2, 2)), data_axis_name="data")
    _, est = loop(jm.params, JaxBelief(*map(jnp.asarray, belief)),
                  jax.tree_util.tree_map(jnp.asarray, obs), jnp.asarray(controls), key)
    return {"ranks": ranks, "jax": np.asarray(est)}


def test_grid_eval_matches_jax(world):
    """The 2 x 2 x 2 grid (2 microbatches a stage) and the data x particle
    loop of the same mesh: JAX's data x particle estimates, on every rank."""
    for rank in world["ranks"]:
        for case in ("grid", "data_particle"):
            four._scale_close(rank[case][1].numpy(), world["jax"], four.EST_RTOL, case)
    counts = world["ranks"][0]["grid_counts"]
    assert counts[("relay", "pipe")] == 2  # stage 0 sends each of its 2 microbatches
    assert counts[("all_reduce_max", "particle")] == T // 2 * 2  # its chunk, twice


def test_grid_bptt_matches_the_plain_bptt(world):
    """BPTT on the 2 x 2 x 2 grid: the plain BPTT's loss and gradients, one
    all-reduce over the mesh summing the pipe and particle shares and
    averaging the data rows."""
    loss_ref, grads_ref = world["ranks"][0]["bptt_plain"]
    for rank in world["ranks"]:
        loss, grads = rank["bptt_grid"]
        np.testing.assert_allclose(loss, loss_ref, rtol=four.LOSS_RTOL)
        for k, g in grads_ref.items():
            four._scale_close(grads[k].numpy(), g.numpy(), four.GRAD_RTOL, k)
