"""A quick proof that the multi-device paths run: ``dryrun_multichip(n)``
(the port's counterpart of the JAX package's ``__graft_entry__.py``
``dryrun_multichip``) starts a world of `n` ranks (``parallel/launch.py``)
and runs, at tiny shapes with the door crossmodal PF, one data-parallel
``train_e2e`` step and the particle-sharded eval loop. It prints a ``DP
OK`` line and a ``particle-sharding OK`` line, and raises when the world
has fewer ranks than asked or a result is not finite.

    python -m multimodalfilter_tpu_torch.parallel.dryrun 4 [--device cuda]
"""

from __future__ import annotations

import argparse
import dataclasses
import tempfile

import numpy as np
import torch

from .launch import spawn

_SEQ_LEN, _PER_RANK_BATCH, _PARTICLES_PER_RANK, _T = 3, 2, 8, 6


def _trajectories(count: int, t: int, seed: int):
    from ..types import Trajectory

    r = np.random.default_rng(seed)
    return [Trajectory(
        0.3 * r.normal(size=(t, 3)).astype(np.float32),
        {"image": r.normal(size=(t, 32, 32)).astype(np.float32),
         "gripper_pos": r.normal(size=(t, 3)).astype(np.float32),
         "gripper_sensors": r.normal(size=(t, 7)).astype(np.float32)},
        r.normal(size=(t, 7)).astype(np.float32)) for _ in range(count)]


def _rank(rank: int, world_size: int, n: int, device: str) -> dict:
    from ..crossmodal import door_models, train_helpers
    from ..experiments import Buddy
    from .data_parallel import Layout, mesh_forward_loop
    from .mesh import create_mesh

    if world_size < n:
        raise RuntimeError(f"dryrun_multichip({n}) found a world of {world_size} ranks")
    model = door_models.DoorCrossmodalParticleFilter(device=device, seed=0)
    model.definition = dataclasses.replace(
        model.definition, num_particles_train=_PARTICLES_PER_RANK,
        num_particles_eval=_PARTICLES_PER_RANK * n)
    mesh = create_mesh(n, device=device)
    with tempfile.TemporaryDirectory(prefix="mmf_dryrun_") as logs:
        buddy = Buddy("dryrun", model, log_dir=logs, verbose=False)
        train_helpers.configure(
            buddy=buddy, trajectories=_trajectories(n * _PER_RANK_BATCH, _SEQ_LEN, 0),
            mesh=mesh)
        loss = train_helpers.train_e2e(subsequence_length=_SEQ_LEN, epochs=1,
                                       batch_size=n * _PER_RANK_BATCH)

    (traj,) = _trajectories(1, _T, 1)
    obs = {k: torch.from_numpy(v[:, None]).to(model.device) for k, v in traj.observations.items()}
    ctrl = torch.from_numpy(traj.controls[:, None]).to(model.device)
    mean = torch.from_numpy(traj.states[:1]).to(model.device)
    cov = 0.1 * torch.eye(3, device=model.device)[None]
    model.eval()
    generator = torch.Generator(device=model.device).manual_seed(0)
    particle_mesh = create_mesh(n, ("particle",), device=device)
    with torch.no_grad():
        belief = model.definition.initialize_beliefs(mean, cov, train=False, generator=generator)
        belief, est = mesh_forward_loop(model.definition,
                                        Layout(particle_mesh, particle_axis="particle"),
                                        belief, obs, ctrl, train=False, generator=generator)
        lse = torch.logsumexp(belief.log_weights, dim=1)
    return {"loss": float(loss), "estimates": est.cpu(), "logsumexp": lse.cpu()}


def dryrun_multichip(n: int, device: str = "cpu") -> None:
    """One DP train step and the particle-sharded eval loop on `n` ranks;
    raises on a failure or a world of fewer ranks."""
    results = spawn(_rank, n, device, n, device)
    first = results[0]
    if len(results) < n or not np.isfinite(first["loss"]):
        raise RuntimeError(f"data-parallel training failed: {first['loss']}")
    if any(r["loss"] != first["loss"] for r in results):
        raise RuntimeError("the ranks disagree on the data-parallel loss")
    print(f"[dryrun_multichip] DP OK: {n} ranks on {device}, "
          f"batch {n * _PER_RANK_BATCH}, loss {first['loss']:.6f}", flush=True)
    est = first["estimates"]
    if not torch.isfinite(est).all() or float(first["logsumexp"].abs().max()) > 1e-4:
        raise RuntimeError("the particle-sharded loop gave non-finite estimates or "
                           "weights that do not normalise")
    if any(not torch.equal(r["estimates"], est) for r in results):
        raise RuntimeError("the ranks disagree on the particle-sharded estimates")
    print(f"[dryrun_multichip] particle-sharding OK: M={_PARTICLES_PER_RANK * n} over "
          f"{n} ranks, estimates {tuple(est.shape)}", flush=True)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("n", type=int)
    parser.add_argument("--device", default="cpu")
    args = parser.parse_args(argv)
    dryrun_multichip(args.n, args.device)


if __name__ == "__main__":
    main()
