"""Rank-side functions of the multi-device tests (no test of its own).

A spawned rank imports the module that defines its function, so this module
imports torch, numpy and the port only, never JAX: the tests compute the
JAX references in the pytest process and hand the ranks numpy inputs, and
each world returns its results to the test (``parallel/launch.py``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import os

import numpy as np
import torch
import torch.distributed as dist

from multimodalfilter_tpu_torch.crossmodal import door_models as tdoor
from multimodalfilter_tpu_torch.parallel import collectives
from multimodalfilter_tpu_torch.parallel.data_parallel import Layout, mesh_forward_loop
from multimodalfilter_tpu_torch.parallel.mesh import create_mesh
from multimodalfilter_tpu_torch.types import ParticleBelief, Trajectory


@contextlib.contextmanager
def world_of_one():
    """An initialised gloo world of this one process, torn down after."""
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


class AxisSizes:
    """A stand-in for a mesh of more ranks than a test's world: its axis
    names and sizes, all that the fit checks read."""

    def __init__(self, **sizes):
        self.mesh_dim_names = tuple(sizes)
        self._sizes = tuple(sizes.values())

    def size(self, dim: int) -> int:
        return self._sizes[dim]


def tensors(tree):
    """numpy arrays (in dicts and tuples) -> tensors."""
    if isinstance(tree, dict):
        return {k: tensors(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(tensors(v) for v in tree)
    return torch.from_numpy(np.ascontiguousarray(tree))


def sequences(t, n, seed=0):
    r = np.random.default_rng(seed)
    obs = {"image": r.normal(size=(t, n, 32, 32)).astype(np.float32),
           "gripper_pos": r.normal(size=(t, n, 3)).astype(np.float32),
           "gripper_sensors": r.normal(size=(t, n, 7)).astype(np.float32)}
    return obs, r.normal(size=(t, n, 7)).astype(np.float32)


def trajectories(count, t, seed=0, cls=Trajectory):
    r = np.random.default_rng(seed)
    out = []
    for _ in range(count):
        obs = {"image": r.normal(size=(t, 32, 32)).astype(np.float32),
               "gripper_pos": r.normal(size=(t, 3)).astype(np.float32),
               "gripper_sensors": r.normal(size=(t, 7)).astype(np.float32)}
        out.append(cls(0.3 * r.normal(size=(t, 3)).astype(np.float32), obs,
                       r.normal(size=(t, 7)).astype(np.float32)))
    return out


def door_pf(state_dict, m_eval=16, m_train=8):
    """The door crossmodal PF with `state_dict`'s weights (numpy arrays: a
    world's inputs pass by value, as tensors would through shared memory,
    one handle each, which is slow to start)."""
    model = tdoor.DoorCrossmodalParticleFilter(device="cpu")
    model.params.load_state_dict(tensors(state_dict))
    model.definition = dataclasses.replace(model.definition, num_particles_eval=m_eval,
                                           num_particles_train=m_train)
    return model


def e2e_batch(b, seq_len, seed):
    r = np.random.default_rng(seed)
    return {"states": torch.from_numpy(0.3 * r.normal(size=(b, seq_len, 3)).astype(np.float32)),
            "controls": torch.from_numpy(r.normal(size=(b, seq_len, 7)).astype(np.float32)),
            "obs": {"image": torch.from_numpy(
                        r.normal(size=(b, seq_len, 32, 32)).astype(np.float32)),
                    "gripper_pos": torch.from_numpy(
                        r.normal(size=(b, seq_len, 3)).astype(np.float32)),
                    "gripper_sensors": torch.from_numpy(
                        r.normal(size=(b, seq_len, 7)).astype(np.float32))}}


def e2e_gradients(model, batch, shard=None, seed=9):
    """The e2e loss of `batch` and every parameter's gradient, on one
    device or through `shard`'s loop and its all-reduce (the global loss and
    gradients, the same on every rank)."""
    from multimodalfilter_tpu_torch.train import loops

    model.params.zero_grad(set_to_none=True)
    generator = torch.Generator().manual_seed(seed)
    if shard is not None:
        batch = loops._gather(batch, torch.arange(shard.batch_size)[shard.rows])
    with torch.enable_grad():
        loss = loops.e2e_loss(model.definition, batch, enabled=(True, True),
                              initial_cov_scale=0.1, generator=generator, shard=shard)
        loss.backward()
    for p in model.params.parameters():
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    if shard is not None:
        loss = shard.all_reduce_gradients(model.params, loss)
    return float(loss.detach()), {k: p.grad.clone() for k, p in model.params.named_parameters()}


def _loop(model, layout, belief, obs, ctrl, eps, uni):
    with torch.no_grad():
        return mesh_forward_loop(model.definition, layout, belief, obs, ctrl, train=False,
                                 enabled=(True, True), eps_seq=eps, uniforms_seq=uni)


def _generic_models():
    """The EKF, the crossmodal KF and the LSTM, each from its seeded init."""
    return {name: getattr(tdoor, name)(device="cpu", seed=1)
            for name in ("DoorKalmanFilter", "DoorCrossmodalKalmanFilter", "DoorLSTMFilter")}


def four_rank_cases(rank, world, inputs):
    """Every case of test_torch_port_multidevice.py, in a world of 4."""
    from multimodalfilter_tpu_torch.parallel.data_parallel import train_shard
    from multimodalfilter_tpu_torch.parallel.particle_sharding import systematic_resample_blocks

    out = {}
    model = door_pf(inputs["params"])
    model.eval()
    obs, ctrl = tensors(inputs["obs"]), tensors(inputs["controls"])
    belief = ParticleBelief(*tensors(inputs["belief"]))
    meshes = {
        "particle": create_mesh(axis_names=("particle",)),
        "data_particle": create_mesh(axis_names=("data", "particle"), shape=(2, 2)),
        "pipe": create_mesh(axis_names=("pipe",)),
        "data_pipe": create_mesh(axis_names=("data", "pipe"), shape=(2, 2)),
        "pipe_particle": create_mesh(axis_names=("pipe", "particle"), shape=(2, 2)),
        "particle_train": create_mesh(axis_names=("pipe", "particle"), shape=(1, 4)),
    }

    # Particle sharding, eval, on JAX's own draws: Q = 4, and Q = 2 with
    # the trajectories split over a 2-wide data axis.
    for name, layout in (("q4", Layout(meshes["particle"], particle_axis="particle")),
                         ("data_q2", Layout(meshes["data_particle"], data_axis="data",
                                            particle_axis="particle"))):
        draws = inputs["particle_draws"][name]
        collectives.reset_counts()
        final, est = _loop(model, layout, belief, obs, ctrl, *tensors(draws))
        out[name] = {"est": est, "log_w": final.log_weights, "particles": final.particles,
                     "counts": dict(collectives.counts)}

    # The offspring counts of the sharded systematic resampler, on generator
    # draws: u0 from a generator seeded alike on every rank, and (to show
    # the check has teeth) seeded by rank.
    r = np.random.default_rng(21)
    n, m = 8, 64
    ids = torch.arange(m, dtype=torch.float32)[None, :, None].expand(n, m, 1)
    log_w = torch.from_numpy(r.normal(scale=2.0, size=(n, m)).astype(np.float32))
    log_w = log_w - torch.logsumexp(log_w, dim=1, keepdim=True)
    mesh = meshes["particle"]
    cols = slice(rank * m // 4, (rank + 1) * m // 4)
    for name, seed in (("shared", 5), ("per_rank", 5 + rank)):
        u0 = torch.rand((n,), generator=torch.Generator().manual_seed(seed))
        picked, new_lw = systematic_resample_blocks(ids[:, cols].contiguous(), log_w[:, cols],
                                                    u0, mesh, "particle")
        out[f"offspring_{name}"] = collectives.all_gather(picked[..., 0], mesh, "particle", 1)
        out[f"offspring_{name}_lw"] = new_lw
    out["offspring_weights"] = log_w.exp()

    # The pipeline on the plain loop's global noise.
    eps, uni = tensors(inputs["loop_draws"])
    for micro in (1, 2, 4):
        out[f"pipe4_micro{micro}"] = _loop(model, Layout(meshes["pipe"], "pipe", micro),
                                           belief, obs, ctrl, eps, uni)
    out["data_pipe_micro2"] = _loop(model, Layout(meshes["data_pipe"], "pipe", 2, "data"),
                                    belief, obs, ctrl, eps, uni)
    u0 = tensors(inputs["particle_draws"]["data_q2"][1])
    eps_q = tensors(inputs["particle_draws"]["data_q2"][0])
    for micro in (1, 2):
        out[f"pipe_particle_micro{micro}"] = _loop(
            model, Layout(meshes["pipe_particle"], "pipe", micro, None, "particle"),
            belief, obs, ctrl, eps_q, u0)

    # A T that does not divide over 4 stages, through the facade.
    model.use_pipeline(meshes["pipe"], num_microbatches=2)
    t = ctrl.shape[0] - 1
    model.belief = belief
    out["padded"] = model.forward_loop(observations={k: v[:t] for k, v in obs.items()},
                                       controls=ctrl[:t], eps_seq=eps, uniforms_seq=uni)
    out["padded_key"] = model.loop_cache_key(ctrl.shape[1])[-1]
    model.use_pipeline(None)

    # The generic loop: the EKF, the crossmodal KF and the LSTM.
    generic = _generic_models()
    mean, cov = tensors(inputs["mean"]), tensors(inputs["cov"])
    for name, kf in generic.items():
        kf.eval()
        with torch.no_grad():
            b0 = kf.definition.initialize_beliefs(mean, cov, train=False)
            ref = kf.definition.forward_loop(b0, obs, ctrl, train=False)
            piped = mesh_forward_loop(kf.definition, Layout(meshes["pipe"], "pipe", 2), b0,
                                      obs, ctrl, train=False)
        out[f"generic_{name}"] = (ref, piped)

    # Pipelined and particle-sharded BPTT against the plain BPTT.
    train_model = door_pf(inputs["params"])
    batch = e2e_batch(8, 5, seed=1)
    out["bptt_plain"] = e2e_gradients(train_model, batch)
    for name, mesh, pipelined, micro in (
            ("dp4", create_mesh(axis_names=("data",)), False, None),
            ("pipe4", meshes["pipe"], True, 2),
            ("data_pipe", meshes["data_pipe"], True, 2),
            ("pipe_particle", meshes["pipe_particle"], True, 2),
            ("particle4", meshes["particle_train"], True, None)):
        shard = train_shard(train_model.definition, mesh, batch_size=8, seq_len=5,
                            pipelined=pipelined, microbatches=micro)
        collectives.reset_counts()
        out[f"bptt_{name}"] = e2e_gradients(train_model, batch, shard)
        out[f"bptt_{name}_counts"] = dict(collectives.counts)

    out["dp_train"] = dp_train_epoch(inputs, create_mesh(axis_names=("data",)))
    return out


def dp_train_epoch(inputs, mesh):
    """One train_e2e epoch on `mesh` (JAX's draws replayed through
    ``draw_noise``) with the gate frozen, and the same epoch on one device
    on rank 0 alone: parameters, losses and the collectives counted."""
    from multimodalfilter_tpu_torch.crossmodal import train_helpers
    from multimodalfilter_tpu_torch.experiments import Buddy
    from multimodalfilter_tpu_torch.filtering.wrappers import freeze_module
    from multimodalfilter_tpu_torch.train import loops

    spec = inputs["dp"]
    real, real_apply = loops.draw_noise, loops.apply_gradients
    results = {}
    for name, use_mesh in (("mesh", mesh), ("single", None)):
        if use_mesh is None and dist.get_rank() != 0:
            continue
        queue = [tuple(torch.from_numpy(x) for x in draws) for draws in spec["draws"]]
        loops.draw_noise = lambda generator, shapes, device: queue.pop(0)
        try:
            model = door_pf(inputs["params"], m_train=spec["m"])
            freeze_module(model.measurement_model.crossmodal_weight_model)
            steps = []

            def recording(optimizer, module, frozen, reduce=None):
                out = real_apply(optimizer, module, frozen, reduce)
                steps.append({k: p.grad.clone() for k, p in module.named_parameters()})
                return out

            loops.apply_gradients = recording
            buddy = Buddy("dp", model, log_dir=os.devnull if dist.get_rank() else spec["logs"],
                          verbose=False)
            train_helpers.configure(buddy=buddy, trajectories=trajectories(
                spec["count"], 2 * spec["seq_len"], seed=spec["seed"]), mesh=use_mesh)
            collectives.reset_counts()
            loss = train_helpers.train_e2e(subsequence_length=spec["seq_len"], epochs=1,
                                           batch_size=spec["batch"])
            results[name] = {"loss": loss, "params": {k: v.clone() for k, v in
                                                      model.params.state_dict().items()},
                             "grads": steps, "steps": buddy.optimizer_steps,
                             "counts": dict(collectives.counts), "left": len(queue)}
        finally:
            loops.draw_noise = real
            loops.apply_gradients = real_apply
    return results


def eight_rank_cases(rank, world, inputs):
    """The full (data, pipe, particle) grid: eval and BPTT."""
    from multimodalfilter_tpu_torch.parallel.data_parallel import train_shard

    model = door_pf(inputs["params"])
    model.eval()
    obs, ctrl = tensors(inputs["obs"]), tensors(inputs["controls"])
    belief = ParticleBelief(*tensors(inputs["belief"]))
    grid = create_mesh(axis_names=("data", "pipe", "particle"), shape=(2, 2, 2))
    out = {}
    eps, u0 = tensors(inputs["draws"])
    collectives.reset_counts()
    out["grid"] = _loop(model, Layout(grid, "pipe", 2, "data", "particle"), belief, obs,
                        ctrl, eps, u0)
    out["grid_counts"] = dict(collectives.counts)
    data_particle = create_mesh(axis_names=("rows", "data", "particle"), shape=(2, 2, 2))
    out["data_particle"] = _loop(model, Layout(data_particle, None, 1, "data", "particle"),
                                 belief, obs, ctrl, eps, u0)
    train_model = door_pf(inputs["params"])
    batch = e2e_batch(8, 5, seed=1)
    out["bptt_plain"] = e2e_gradients(train_model, batch)
    shard = train_shard(train_model.definition, grid, batch_size=8, seq_len=5, pipelined=True,
                        microbatches=2)
    out["bptt_grid"] = e2e_gradients(train_model, batch, shard)
    return out


CLI_ENV = {"MMF_TPU_SYNTHESIZE_DATA": "1", "MMF_TPU_SYNTH_T": "16", "MMF_TPU_SYNTH_TRAJ": "2",
           "MMF_TPU_OFFLINE": "1", "MMF_TPU_EVAL_DEVICE_THROUGHPUT": "0",
           "MMF_TPU_EVAL_BATCH_REPEATS": "0"}
DATASET_ARGS = dict(use_vision=True, use_proprioception=True, use_haptics=True,
                    image_blackout_ratio=0.0, sequential_image_rate=1)


def _short_curriculum(filter_model, buddy, train_helpers, eval_helpers):
    """Two optimizer steps of e2e BPTT and a checkpoint."""
    train_helpers.train_e2e(subsequence_length=3, epochs=1, batch_size=8)
    buddy.save_checkpoint("phase0")


def two_rank_cases(rank, world, inputs):
    """test_torch_port_multidevice_cli.py's cases, in a world of 2: the
    data-parallel eval against one device, configure's checks, the train CLI
    with --data-parallel 2 (each rank in its own working directory) and the
    eval CLI with --pipeline-stages 2 on its checkpoint, and a
    data-parallel epoch at W = 2."""
    from multimodalfilter_tpu_torch.crossmodal import eval_helpers
    from multimodalfilter_tpu_torch.crossmodal.tasks import DoorTask
    from multimodalfilter_tpu_torch.data import cache
    from multimodalfilter_tpu_torch.experiments import Buddy
    from multimodalfilter_tpu_torch.scripts.door_task import eval_door, train_door

    os.environ.update(CLI_ENV)
    cache.set_cache_path(inputs["cache"])
    out = {}
    work = os.path.join(inputs["work"], f"rank{rank}")
    os.makedirs(work)
    os.chdir(work)

    # Data-parallel eval against the same eval on one device.
    model = tdoor.DoorCrossmodalParticleFilter(device="cpu", seed=4)
    buddy = Buddy("dp_eval", model, log_dir=os.path.join(inputs["work"], "logs"),
                  verbose=False)
    mesh = create_mesh(2)
    runs = {}
    for name, use_mesh in (("mesh", mesh), ("single", None)):
        model.generator.manual_seed(11)
        eval_helpers.configure(buddy=buddy, task=DoorTask, dataset_args=dict(DATASET_ARGS),
                               mesh=use_mesh)
        runs[name] = eval_helpers.run_eval()
        os.environ["MMF_TPU_EVAL_BATCH_REPEATS"] = "1"
        model.generator.manual_seed(12)
        runs[f"{name}_stats"] = eval_helpers.run_eval_stats(repeats=2)
        os.environ["MMF_TPU_EVAL_BATCH_REPEATS"] = "0"
    out["dp_eval"] = runs
    errors = {}
    for name, kwargs in (
            ("axis", {"mesh": create_mesh(2, ("pipe",))}),
            ("both", {"mesh": mesh, "pipeline_mesh": create_mesh(2, ("pipe",))})):
        try:
            eval_helpers.configure(buddy=buddy, task=DoorTask, dataset_args=DATASET_ARGS,
                                   **kwargs)
        except ValueError as exc:
            errors[name] = str(exc)
    out["configure_errors"] = errors

    # The train CLI, data-parallel over the two ranks, each in its own
    # working directory; then the eval CLI pipelined over them, both ranks
    # in rank 0's directory.
    argv = ["--model-type", "DoorCrossmodalParticleFilter", "--experiment-name", "dp_cli",
            "--device", "cpu", "--data-parallel", "2"]
    out["train"] = train_door.run(DoorTask, _short_curriculum, argv, cache_dir=inputs["cache"])
    out["train_files"] = sorted(os.path.relpath(os.path.join(d, f), work)
                                for d, _, files in os.walk(work) for f in files)
    out["params"] = {k: v.clone() for k, v in
                     eval_helpers.filter_model.params.state_dict().items()}
    dist.barrier()
    os.chdir(os.path.join(inputs["work"], "rank0"))
    out["eval_pipelined"] = eval_door.main(
        ["--experiment-name", "dp_cli", "--device", "cpu", "--pipeline-stages", "2"],
        cache_dir=inputs["cache"])
    out["dp_train"] = dp_train_epoch(inputs, create_mesh(2))
    return out


def export_rank_cases(rank, world, inputs):
    """A pipelined serving bundle in a world of 2: the crossmodal PF with a
    2-stage pipeline (2 microbatches) is exported (rank 0 writes) and
    loaded on both ranks; the bundle's loop against the live pipelined
    model's, from the same seed."""
    from multimodalfilter_tpu_torch.experiments.export import (
        export_serving_bundle, load_serving_bundle)

    obs, ctrl = tensors(inputs["obs"]), tensors(inputs["controls"])
    mean, cov = tensors(inputs["mean"]), tensors(inputs["cov"])
    out = {}
    for name, axes in (("pipe", ("pipe",)),):
        model = door_pf(inputs["params"], m_eval=inputs["m"])
        model.eval()
        model.use_pipeline(create_mesh(axis_names=axes), num_microbatches=2)
        path = os.path.join(inputs["work"], name)
        export_serving_bundle(model, path, observations=obs, controls=ctrl, mean=mean,
                              covariance=cov)
        model.generator.manual_seed(0)
        model.initialize_beliefs(mean=mean, covariance=cov)
        live = model.forward_loop(observations=obs, controls=ctrl)
        bundle = load_serving_bundle(path, seed=0)
        bundle.initialize_beliefs(mean=mean, covariance=cov)
        served = bundle.forward_loop(observations=obs, controls=ctrl)
        out[name] = {"live": live, "served": served, "meta": bundle.meta["pipeline"],
                     "belief": (model.belief.particles, bundle.belief.particles)}
    return out


def export_particle_rank_cases(rank, world, inputs):
    """Pipelined bundles of grids with a particle axis, in a world of 4 (pipe
    2 x particle 2) or 8 (data 2 x pipe 2 x particle 2): the bundle against
    the live pipelined model from the same seed, with the collectives each
    counts; a ragged T and a bundle whose recorded group name was altered,
    each raising; and the live loop (micro 1) on JAX's per-shard draws."""
    import json
    import shutil
    import warnings

    from multimodalfilter_tpu_torch.experiments.export import (
        export_serving_bundle, load_serving_bundle)

    obs, ctrl = tensors(inputs["obs"]), tensors(inputs["controls"])
    mean, cov = tensors(inputs["mean"]), tensors(inputs["cov"])
    axes, shape = inputs["axes"], inputs["shape"]
    mesh = create_mesh(axis_names=axes, shape=shape)
    out = {}
    model = door_pf(inputs["params"], m_eval=inputs["m"])
    model.eval()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the particle axis bypasses the kernels
        model.use_pipeline(mesh, num_microbatches=2)
    path = os.path.join(inputs["work"], "grid")
    export_serving_bundle(model, path, observations=obs, controls=ctrl, mean=mean,
                          covariance=cov)
    model.generator.manual_seed(0)
    model.initialize_beliefs(mean=mean, covariance=cov)
    collectives.reset_counts()
    live = model.forward_loop(observations=obs, controls=ctrl)
    live_counts = dict(collectives.counts)
    bundle = load_serving_bundle(path, seed=0)
    bundle.initialize_beliefs(mean=mean, covariance=cov)
    collectives.reset_counts()
    served = bundle.forward_loop(observations=obs, controls=ctrl)
    out["grid"] = {"live": live, "served": served, "meta": bundle.meta["pipeline"],
                   "live_counts": live_counts, "served_counts": dict(collectives.counts),
                   "belief": (tuple(model.belief), tuple(bundle.belief))}

    # A T that does not divide over the stages does not export.
    try:
        export_serving_bundle(model, os.path.join(inputs["work"], "ragged"),
                              observations={k: v[:-1] for k, v in obs.items()},
                              controls=ctrl[:-1], mean=mean, covariance=cov)
        out["ragged"] = None
    except ValueError as exc:
        out["ragged"] = str(exc)

    # A recorded group name that is not the program's: the load raises.
    altered = os.path.join(inputs["work"], "altered")
    if rank == 0:
        shutil.copytree(path, altered)
        with open(os.path.join(altered, "meta.json")) as f:
            meta = json.load(f)
        meta["pipeline"]["groups"]["particle"] = "no such group"
        with open(os.path.join(altered, "meta.json"), "w") as f:
            json.dump(meta, f)
    dist.barrier()
    try:
        load_serving_bundle(altered, seed=0)
        out["altered"] = None
    except ValueError as exc:
        out["altered"] = str(exc)

    # The live loop through the functional collectives at micro 1, on the
    # draws of JAX's particle-sharded step.
    eps, u0 = tensors(inputs["particle_draws"])
    out["live_micro1"] = _loop(model, Layout(mesh, "pipe", 1, "data" if "data" in axes else None,
                                             "particle"),
                               ParticleBelief(*tensors(inputs["belief"])), obs, ctrl, eps, u0)[1]
    return out


class TinyParams:
    """A model as ``Buddy`` sees one: ``params``, a module whose state-dict
    keys are dotted paths ("dynamics_model.w", ...)."""

    def __init__(self, arrays):
        self.params = torch.nn.ModuleDict({
            part: torch.nn.ParameterDict({k: torch.nn.Parameter(torch.from_numpy(v.copy()))
                                          for k, v in leaves.items()})
            for part, leaves in arrays.items()})


def async_checkpoint_rank(rank, world, inputs):
    """A world of 2 with the asynchronous backend: rank 0's writes are slowed
    down, so that a rank that read before the commit would find no file or
    the one before. Both ranks save, change their parameters in place, read
    the checkpoint back (and one submodule of another), and return what they
    read."""
    from multimodalfilter_tpu_torch.experiments import Buddy, buddy as buddy_module

    real = buddy_module._write_atomically

    def slow(state, path):
        import time

        time.sleep(inputs["delay_s"])
        real(state, path)

    buddy_module._write_atomically = slow
    model = TinyParams(inputs["arrays"])
    buddy = Buddy("async_world", model, checkpoint_dir=inputs["ckpt"],
                  metadata_dir=inputs["meta"], log_dir=inputs["logs"],
                  checkpoint_backend="orbax", verbose=False)
    out = {"saved": {k: v.detach().clone() for k, v in model.params.state_dict().items()}}
    buddy.increment_steps(3)
    buddy.save_checkpoint("first")
    with torch.no_grad():
        for p in model.params.parameters():
            p.mul_(2.0).add_(1.0)
    buddy.save_checkpoint("second")  # joins the first write
    with torch.no_grad():
        for p in model.params.parameters():
            p.zero_()
    buddy.load_checkpoint("first")
    out["first"] = {k: v.detach().clone() for k, v in model.params.state_dict().items()}
    out["steps"] = buddy.optimizer_steps
    buddy.load_checkpoint_module("measurement_model", label="second")
    out["surgery"] = {k: v.detach().clone() for k, v in model.params.state_dict().items()}
    buddy.wait_for_checkpoints()
    out["files"] = sorted(os.listdir(os.path.join(inputs["ckpt"], "async_world")))
    return out


def fail_while_others_wait(rank, world):
    """Rank 1 fails at once; rank 0 waits in a collective for it forever."""
    if rank == 1:
        raise RuntimeError("rank 1 fails")
    dist.barrier()
    return rank
