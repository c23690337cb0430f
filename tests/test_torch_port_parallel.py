"""The multi-device layer's pieces that need no world of several ranks:
the CLI flags' meshes against the JAX package's ``meshes_from_args``, the
microbatch and padding rules against its facade's, the facade's pipeline
checks, ``local_rows``, the hybrid mesh's rank layout, and the kernel
build's lock (one build per machine when the ranks of a world start
together). The paths themselves run in worlds of 2, 4 and 8 ranks:
test_torch_port_multidevice{,_cli,_grid}.py."""

import argparse
import sys
import threading
import time
import warnings

import numpy as np
import pytest
import torch

from multimodalfilter_tpu.filtering.wrappers import StatefulFilter as JaxStatefulFilter
from multimodalfilter_tpu.filtering.wrappers import pad_time_to_stages as jax_pad
from multimodalfilter_tpu.parallel import cli as jax_cli
from multimodalfilter_tpu_torch.crossmodal import door_models as tdoor
from multimodalfilter_tpu_torch.filtering.wrappers import StatefulFilter, pad_time_to_stages
from multimodalfilter_tpu_torch.ops import _build
from multimodalfilter_tpu_torch.parallel import cli
from multimodalfilter_tpu_torch.parallel.mesh import create_mesh, hybrid_rank_grid, local_rows
from multimodalfilter_tpu_torch.types import ParticleBelief

sys.path.insert(0, "tests")
import test_torch_port_dist_worker as worker  # noqa: E402


def _args(add, argv):
    parser = argparse.ArgumentParser()
    add(parser)
    return parser.parse_args(argv)


@pytest.mark.parametrize("argv", [
    [], ["--data-parallel", "2"], ["--pipeline-stages", "4"],
    ["--data-parallel", "2", "--pipeline-stages", "4"], ["--particle-shards", "4"],
    ["--data-parallel", "2", "--pipeline-stages", "2", "--particle-shards", "2"],
    ["--pipeline-stages", "2", "--pipeline-microbatches", "3"],
    ["--pipeline-stages", "1"], ["--data-parallel", "2", "--particle-shards", "2"],
])
def test_flags_ask_for_the_jax_clis_meshes(argv):
    """Each flag combination asks for the meshes JAX's meshes_from_args
    builds (on its 8 virtual CPU devices): the data mesh's size, and the
    grid's axes and shape, the particle-only request on a 1-stage pipe with
    one microbatch."""
    jargs = _args(jax_cli.add_parallelism_args, argv)
    jmesh, jgrid = jax_cli.meshes_from_args(jargs)
    args = _args(cli.add_parallelism_args, argv)
    data, grid = cli.mesh_layouts(args)
    assert data == (None if jmesh is None else jmesh.shape["data"])
    if jgrid is None:
        assert grid is None
    else:
        assert grid == (list(jgrid.axis_names), [jgrid.shape[a] for a in jgrid.axis_names])
    assert args.pipeline_microbatches == jargs.pipeline_microbatches


@pytest.mark.parametrize("argv,need", [
    (["--data-parallel", "2"], 2), (["--pipeline-stages", "2"], 2),
    (["--data-parallel", "2", "--pipeline-stages", "2", "--particle-shards", "2"], 8),
])
def test_a_mesh_larger_than_the_world_exits_naming_torchrun(argv, need):
    """This process is a world of one: a flag asking for more exits before
    any process group exists, naming the launch it needs."""
    args = _args(cli.add_parallelism_args, argv)
    with pytest.raises(SystemExit, match=f"torchrun --nproc-per-node {need}"):
        cli.meshes_from_args(args, device="cpu")
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("flag", ["--data-parallel", "--pipeline-stages",
                                  "--pipeline-microbatches", "--particle-shards"])
def test_a_flag_below_one_exits(flag):
    for add, build in ((cli.add_parallelism_args, lambda a: cli.meshes_from_args(a, "cpu")),
                       (jax_cli.add_parallelism_args, jax_cli.meshes_from_args)):
        with pytest.raises(SystemExit, match=">= 1"):
            build(_args(add, [flag, "0"]))


def test_one_device_mesh_without_a_launcher():
    """--data-parallel 1 in a single process builds a mesh of one over a
    world of one (an in-memory store), as JAX's create_mesh(1) does."""
    args = _args(cli.add_parallelism_args, ["--data-parallel", "1"])
    try:
        mesh, grid = cli.meshes_from_args(args, device="cpu")
        assert grid is None and mesh.mesh_dim_names == ("data",) and mesh.size() == 1
    finally:
        torch.distributed.destroy_process_group()


@pytest.mark.parametrize("n", list(range(1, 41)))
def test_auto_microbatches_match_jax(n):
    assert StatefulFilter._auto_microbatches(n) == JaxStatefulFilter._auto_microbatches(n)


@pytest.mark.parametrize("t,stages", [(5, 4), (8, 4), (7, 1), (3, 8)])
def test_pad_time_to_stages_matches_jax(t, stages):
    r = np.random.default_rng(t)
    obs = {"image": r.normal(size=(t, 2, 4)).astype(np.float32)}
    ctrl = r.normal(size=(t, 2, 7)).astype(np.float32)
    jobs, jctrl = jax_pad(obs, ctrl, stages)
    tobs, tctrl = pad_time_to_stages({"image": torch.from_numpy(obs["image"])},
                                     torch.from_numpy(ctrl), stages)
    np.testing.assert_array_equal(tobs["image"].numpy(), np.asarray(jobs["image"]))
    np.testing.assert_array_equal(tctrl.numpy(), np.asarray(jctrl))


class _RankView(worker.AxisSizes):
    """A stand-in mesh seen from one rank: its coordinate on each axis."""

    def __init__(self, coordinate, **sizes):
        super().__init__(**sizes)
        self._coordinate = dict(zip(sizes, coordinate))

    def get_local_rank(self, name):
        return self._coordinate[name]


def test_local_rows_concatenate_back_to_the_batch():
    """Every rank's rows, concatenated in mesh order, give the global batch
    back, for a tensor, a dict and a named tuple, on axis 0 and axis 1."""
    x = torch.arange(2 * 8 * 3).reshape(2, 8, 3)
    belief = ParticleBelief(torch.randn(8, 5, 3), torch.randn(8, 5))
    views = [_RankView((r,), data=4) for r in range(4)]
    torch.testing.assert_close(torch.cat([local_rows(x, v, axis=1) for v in views], 1), x)
    parts = [local_rows({"b": belief}, v)["b"] for v in views]
    for i, leaf in enumerate(belief):
        torch.testing.assert_close(torch.cat([p[i] for p in parts]), leaf)
    assert type(parts[0]) is ParticleBelief and parts[1].particles.shape == (2, 5, 3)
    with pytest.raises(ValueError, match="does not split"):
        local_rows(torch.zeros(6), _RankView((0,), data=4))


def test_hybrid_mesh_keeps_machines_outermost():
    """ici (2, 2) within a machine of 4 ranks, dcn (2, 1) across 2
    machines: index d*2 + i of axis 0 is machine d's local coordinate i, and
    torchrun numbers a machine's ranks together."""
    grid = hybrid_rank_grid((2, 2), (2, 1))
    assert grid.shape == (4, 2)
    machine = grid // 4
    np.testing.assert_array_equal(machine, [[0, 0], [0, 0], [1, 1], [1, 1]])
    assert sorted(grid.flatten().tolist()) == list(range(8))
    np.testing.assert_array_equal(hybrid_rank_grid((2, 2), (1, 1)), np.arange(4).reshape(2, 2))


def test_use_pipeline_checks_the_mesh():
    """As the JAX facade: a mesh without the pipeline's axis is refused, a
    'particle' axis is refused for a filter without particles and, for a
    particle filter, warns that the collective tail bypasses the kernels;
    the loop's cache key carries the layout."""
    pf = tdoor.DoorCrossmodalParticleFilter(device="cpu")
    kf = tdoor.DoorKalmanFilter(device="cpu")
    with pytest.raises(ValueError, match="no 'pipe' axis"):
        pf.use_pipeline(worker.AxisSizes(data=2))
    with pytest.raises(ValueError, match="particle"):
        kf.use_pipeline(worker.AxisSizes(pipe=2, particle=2))
    with pytest.warns(UserWarning, match="bypassed"):
        pf.use_pipeline(worker.AxisSizes(pipe=2, particle=2))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        pf.use_pipeline(worker.AxisSizes(data=2, pipe=2), num_microbatches=4)
    assert pf._pipeline[1:] == ("pipe", 4, "data", None)
    pf.use_pipeline(None)
    plain = pf.loop_cache_key(8)
    with worker.world_of_one():
        pf.use_pipeline(create_mesh(1, ("pipe",), device="cpu"))
        piped = pf.loop_cache_key(8)
        pf.use_pipeline(None)
    assert plain[-1] is None and pf.loop_cache_key(8) == plain and piped[:-1] == plain[:-1]
    assert piped[-1].pipe_axis == "pipe" and piped[-1].micro == 8


def _stub_compiler(tmp_path, log):
    stub = tmp_path / "nvcc"
    stub.write_text("#!/bin/sh\n"
                    f"echo built >> {log}\n"
                    "sleep 1\n"
                    "out=$(for a; do if [ \"$prev\" = \"-o\" ]; then echo $a; fi; prev=$a; done)\n"
                    "echo lib > $out\n")
    stub.chmod(0o755)
    return str(stub)


def test_a_concurrent_build_waits_and_builds_nothing(tmp_path, monkeypatch):
    """Two callers of build() at once (the ranks of a world reaching their
    first kernel together): the first compiles (a stub compiler that takes a
    second), the second waits on the lock, finds the library fresh and
    builds nothing."""
    csrc, build_dir = tmp_path / "csrc", tmp_path / "build"
    csrc.mkdir()
    (csrc / "k.cu").write_text("// a kernel\n")
    log = tmp_path / "calls.log"
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", build_dir)
    monkeypatch.setattr(_build, "_nvcc", lambda: _stub_compiler(tmp_path, log))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    results = {}

    def caller(name):
        start = time.monotonic()
        results[name] = (_build.build(["k"]), time.monotonic() - start)

    threads = [threading.Thread(target=caller, args=(name,)) for name in ("a", "b")]
    for thread in threads:
        thread.start()
        time.sleep(0.2)
    for thread in threads:
        thread.join(timeout=60)
        assert not thread.is_alive()
    assert sorted(built for built, _ in results.values()) == [[], ["k"]]
    assert log.read_text().count("built") == 1
    assert min(seconds for _, seconds in results.values()) >= 0.7  # the second waited
    assert (build_dir / "libk.so").read_text() == "lib\n"


def test_a_failed_rank_fails_the_world_at_once():
    """A rank that fails leaves the others in a collective: it leaves at
    once (a teardown would wait on them), spawn stops them all and raises
    with the failed rank's traceback, long before the world's time limit."""
    from multimodalfilter_tpu_torch.parallel.launch import spawn

    start = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 fails"):
        spawn(worker.fail_while_others_wait, 2, "cpu", timeout_s=120)
    assert time.monotonic() - start < 60


def test_export_refuses_a_pipeline_with_a_particle_axis(tmp_path):
    """A pipelined bundle with a particle axis holds one stage's chunk
    program over one particle block, so export refuses a particle axis that
    the M = 300 eval particles do not divide over, before any tracing,
    naming the axis (the bundles of pipe x particle grids:
    test_torch_port_particle_export.py)."""
    from multimodalfilter_tpu_torch.experiments.export import export_serving_bundle

    obs, controls = worker.sequences(4, 2)
    pf = tdoor.DoorCrossmodalParticleFilter(device="cpu")
    with pytest.warns(UserWarning, match="bypassed"):
        pf.use_pipeline(worker.AxisSizes(pipe=2, particle=7))
    with pytest.raises(ValueError, match="M=300 particles do not split over the 7-way "
                                         "'particle' axis"):
        export_serving_bundle(pf, str(tmp_path / "bundle"), observations=obs, controls=controls)
    assert not (tmp_path / "bundle").exists()
