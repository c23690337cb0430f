"""Serving export (port of ``multimodalfilter_tpu/experiments/export.py``):
freeze a filter's eval rollout into a bundle that runs with no model code.

A bundle holds the two programs a deployed filter needs, each traced once
and saved with ``torch.export``: ``initialize_beliefs`` and the eval
``forward_loop`` (the encoders hoisted over all T*N frames, then the steps).
The def's serving transforms at export time (the fused route, bf16 encoders,
the folded tail, stacked encoders, ``stack_children``) and the enabled mask
freeze into them; train mode is off. The hand-written kernels stay kernels:
the programs hold B1 (``mmf_torch::pf_tail``) and B3
(``mmf_torch::fused_forward``) as custom ops (``ops/custom_ops.py``), as a
JAX artifact embeds its Pallas kernels as custom calls.

Each program is first traced to ATen operations by ``make_fx`` on fake
tensors, which runs ``torch.func`` transforms (the EKF's ``vmap(jacrev)``,
``stack_children``'s ``vmap``) into plain operations, then exported. The
parameters are an input of both programs, saved beside them.

The random draws are inputs, not traced: the belief's initial noise, and
each loop's process noise and resampling uniforms. ``ServingBundle`` draws
them from a ``torch.Generator`` on the bundle's device seeded as
``StatefulFilter`` seeds its own, in the same shapes and order as the live
facade, so a bundle replays its source model bitwise on the same device.
The Kalman filters and the LSTM draw nothing.

Bundle layout (a directory):
    meta.json   format, def, shapes and dtypes, draws, device, torch version
    init.pt2    (params, mean, covariance, *init draws) -> belief leaves
    loop.pt2    (params, belief leaves, observations, controls, *loop draws)
                -> (belief leaves, estimates)
    params.pt   the parameters and buffers, by dotted path

Usage:
    export_serving_bundle(filter_model, "bundle/", observations=obs,
                          controls=ctrl)
    served = load_serving_bundle("bundle/")
    served.initialize_beliefs(mean=m, covariance=c)
    estimates = served.forward_loop(observations=obs, controls=ctrl)

The load side imports ``ops`` (which registers the custom ops), ``types``
and the collectives of ``parallel`` only: no model zoo, no ``filtering``. A
bundle exported for CUDA raises where CUDA is missing.

A model with a temporal pipeline configured (``use_pipeline`` on a 1-, 2-
or 3-D grid of "data", "pipe" and "particle" axes) exports as a pipelined
bundle: ``loop.pt2`` is one stage's program, the per-step loop over a T/P
chunk of one microbatch (shapes are static, so T must divide over the
stages at export), and ``meta.json`` records the mesh's axes and shape, the
pipe, data and particle axes, the stages and the microbatches. Loaded in a
world of the recorded size (``torchrun --nproc-per-node N``),
``ServingBundle.forward_loop`` runs the pipeline's schedule and relay
(``parallel/schedule.py``) around that program on each rank, with the live
model's global draws, and returns the global estimates on every rank.

With a "particle" axis the chunk is the particle-sharded loop over one
block of M/Q particles (``parallel/particle_sharding.py``), and its
collectives (a max and a sum all-reduce a step, and the resampling's
all-gather) are in the program as functional collectives. The program
takes the block's place on the axis as an input, and names each
collective's process group by the exporting rank's name for it: the meta
records those names (``groups``), and the load rebinds them to this rank's
groups of the rebuilt mesh, raising where the program and the meta do not
match. The meta also records the collectives of one program call, which
``collectives.counts`` adds at every call. A mesh with a particle axis and
no pipeline is a (1, Q) pipe x particle grid, as in the JAX package, where
``use_pipeline`` needs a pipe axis.
"""

from __future__ import annotations

import collections
import json
import os
from typing import Any, Dict, List

import torch

from .. import types
from ..ops import custom_ops  # noqa: F401  (registers mmf_torch::* for load)
from ..ops import fused_step

_FORMAT_VERSION = 1
META, INIT, LOOP, PARAMS = "meta.json", "init.pt2", "loop.pt2", "params.pt"
_DRAWS = {"normal": torch.randn, "uniform": torch.rand}
_BELIEF_TYPES = {cls.__name__: cls for cls in (types.ParticleBelief, types.GaussianBelief)}


# ---------------------------------------------------------------------------
# Specs, draws and belief structure
# ---------------------------------------------------------------------------


def _spec(x) -> List[Any]:
    return [list(x.shape), str(x.dtype).replace("torch.", "")]


def _spec_tree(x):
    return {k: _spec(v) for k, v in x.items()} if isinstance(x, dict) else _spec(x)


def _draw_specs(defn, n: int, t: int, stratified: bool = False) -> Dict[str, List[Any]]:
    """The draws of ``defn``'s eval ``initialize_beliefs`` and
    ``forward_loop`` over N trajectories of T steps, in the order the
    facade makes them: [kind, shape]. A particle filter draws its initial
    particles' noise, then each loop's process noise and uniforms (with
    `stratified`, a particle-sharded loop's, one offset a row); the other
    filters draw nothing."""
    if not hasattr(defn, "num_particles"):
        return {"init": [], "loop": []}
    m, d = defn.num_particles(False), defn.state_dim
    return {"init": [["normal", [n, m, d]]],
            "loop": [["normal", [t, n * m, d]],
                     ["uniform", [t, n] if stratified else [t, n, m]]]}


def _structure(belief):
    """(JSON structure, tensor leaves) of a belief: the NamedTuples of
    ``types`` and tuples of them."""
    if isinstance(belief, torch.Tensor):
        return "tensor", [belief]
    if type(belief).__name__ in _BELIEF_TYPES or isinstance(belief, tuple):
        parts = [_structure(x) for x in belief]
        leaves = [leaf for _, sub in parts for leaf in sub]
        kind = type(belief).__name__ if hasattr(belief, "_fields") else "tuple"
        return {kind: [s for s, _ in parts]}, leaves
    raise TypeError(f"cannot export a belief holding {type(belief).__name__}")


def _rebuild(structure, leaves):
    """The belief of ``structure`` from an iterator over its leaves."""
    if structure == "tensor":
        return next(leaves)
    (kind, parts), = structure.items()
    items = tuple(_rebuild(s, leaves) for s in parts)
    return items if kind == "tuple" else _BELIEF_TYPES[kind](*items)


# ---------------------------------------------------------------------------
# Export
# ---------------------------------------------------------------------------


class _Bound(torch.nn.Module):
    """The filter's parameters as a module, for ``functional_call`` to swap
    the program's parameter input in."""

    def __init__(self, params: torch.nn.Module, fn):
        super().__init__()
        self.params = params
        self._fn = fn

    def forward(self, *args):
        return self._fn(*args)


def _program(filter_model, fn, params, args):
    """``fn(*args)``, run on ``params`` in place of the model's own, traced
    to ATen operations on fake tensors and exported."""
    from torch.fx.experimental.proxy_tensor import make_fx

    bound = _Bound(filter_model.params, fn)

    def call(params, *args):
        return torch.func.functional_call(
            bound, {f"params.{k}": v for k, v in params.items()}, args)

    graph = make_fx(call, tracing_mode="fake")(params, *args)
    program = torch.export.export(graph, (params, *args))
    # Functional now: drop the operations whose results nothing reads (some
    # torch versions leave there an unbind of an empty axis, from the EKF's
    # jacrev, which they then fail to load).
    program.graph.eliminate_dead_code()
    program.graph_module.recompile()
    program.example_inputs = None  # the parameters are saved once, in PARAMS
    return program


def export_serving_bundle(filter_model, path: str, *, observations, controls,
                          mean=None, covariance=None) -> str:
    """Export ``filter_model``'s eval rollout as a serving bundle at ``path``.

    Args:
        filter_model: a ``StatefulFilter``; its def's serving transforms and
            enabled mask at this call freeze into the bundle, in eval mode.
        observations / controls: example (T, N, ...) inputs (arrays or
            tensors) fixing the bundle's shapes: export one bundle per
            (T, N).
        mean / covariance: example belief-init moments; default zeros of
            (N, state_dim) and identities of (N, state_dim, state_dim).

    Returns the bundle directory. The meta records whether a def with the
    fused route took it (``fused_route``) and, if not, why
    (``packing_report``).
    """
    defn = filter_model.definition
    enabled = filter_model._enabled_tuple
    def example(x):
        return filter_model._to_device(x).contiguous()

    observations = {k: example(v) for k, v in observations.items()}
    controls = example(controls)
    t, n = controls.shape[:2]
    d = defn.state_dim
    mean = example(torch.zeros(n, d) if mean is None else mean)
    covariance = example(torch.eye(d).repeat(n, 1, 1) if covariance is None else covariance)
    layout = filter_model._layout(n) if getattr(filter_model, "_pipeline", None) else None
    particle_axis = None if layout is None else layout.particle_axis
    draws = _draw_specs(defn, n, t, stratified=particle_axis is not None)

    def fake_draws(kind):
        return [torch.zeros(shape, device=filter_model.device) for _, shape in draws[kind]]

    params = {**dict(filter_model.params.named_parameters()),
              **dict(filter_model.params.named_buffers())}
    params = {k: v.detach() for k, v in params.items()}

    def init_fn(mean, covariance, *eps):
        kwargs = {"eps": eps[0]} if eps else {}
        belief = defn.initialize_beliefs(mean, covariance, train=False, **kwargs)
        return tuple(_structure(belief)[1])

    with torch.no_grad():
        belief = defn.initialize_beliefs(mean, covariance, train=False,
                                         **({"eps": fake_draws("init")[0]}
                                            if draws["init"] else {}))
    structure, leaves = _structure(belief)

    if layout is None:
        pipeline, loop_defn = None, defn
        loop_args = (tuple(leaves), observations, controls, *fake_draws("loop"))
    else:  # the program of one stage's chunk of one microbatch (and particle block)
        pipeline, chunk = _pipeline_chunk(filter_model, layout, n, t, draws)
        loop_defn, steps, rows, cols = chunk["defn"], chunk["steps"], chunk["rows"], chunk["cols"]
        loop_args = (tuple(x[:rows, :cols] for x in leaves) if particle_axis else
                     tuple(x[:rows] for x in leaves),
                     {k: v[:steps, :rows].contiguous() for k, v in observations.items()},
                     controls[:steps, :rows].contiguous(), *chunk["draws"])
    from ..parallel import collectives
    from ..parallel.mesh import barrier, is_writer

    if not is_writer():  # in a multi-device run rank 0 traces and writes the bundle
        barrier()
        return path

    def loop_fn(leaves, observations, controls, *loop_draws):
        belief = _rebuild(structure, iter(leaves))
        if particle_axis is None:
            kwargs = dict(zip(("eps_seq", "uniforms_seq"), loop_draws))
            belief, estimates = loop_defn.forward_loop(belief, observations, controls,
                                                       train=False, enabled=enabled, **kwargs)
        else:
            from ..parallel.particle_sharding import particle_sharded_loop

            eps, u0, block_index = loop_draws
            belief, estimates = particle_sharded_loop(
                loop_defn, layout.mesh, belief, observations, controls, train=False,
                eps_seq=eps, u0_seq=u0, enabled=enabled, axis_name=particle_axis,
                block_index=block_index)
        return tuple(_structure(belief)[1]), estimates

    init = _program(filter_model, init_fn, params, (mean, covariance, *fake_draws("init")))
    # The trace runs the chunk's Python once: the collectives it counts are
    # one call's, which the bundle adds at each of its calls.
    before = collectives.counts.copy()
    try:
        loop = _program(filter_model, loop_fn, params, loop_args)
        per_call = collectives.counts - before
    finally:
        collectives.counts.clear()
        collectives.counts.update(before)
    if pipeline is not None:
        pipeline["collectives"] = sorted([op, axis, n] for (op, axis), n in per_call.items())
    fused = None
    if getattr(loop_defn, "fused_step", False):
        fused = fused_step.packing_report() is None

    os.makedirs(path, exist_ok=True)
    torch.export.save(init, os.path.join(path, INIT))
    torch.export.save(loop, os.path.join(path, LOOP))
    torch.save({k: v.cpu() for k, v in params.items()}, os.path.join(path, PARAMS))
    meta: Dict[str, Any] = {
        "format": _FORMAT_VERSION,
        "definition": type(defn).__name__,
        "state_dim": d,
        "enabled": list(enabled) if enabled is not None else None,
        "device": filter_model.device.type,
        "torch_version": torch.__version__,
        "pipeline": pipeline,
        "observations_spec": _spec_tree(observations),
        "controls_spec": _spec(controls),
        "mean_spec": _spec(mean),
        "covariance_spec": _spec(covariance),
        "belief": structure,
        "init_draws": draws["init"],
        "loop_draws": draws["loop"],
        "fused_route": fused,
        "packing_report": fused_step.packing_report() if fused is False else None,
    }
    with open(os.path.join(path, META), "w") as f:
        json.dump(meta, f, indent=2)
    barrier()
    return path


def _pipeline_chunk(filter_model, layout, n: int, t: int, draws):
    """(the meta's "pipeline" record, the chunk program's def, steps, rows,
    particle columns and example draws) of a model with a pipeline
    configured on `layout`."""
    import dataclasses

    from ..parallel import collectives
    from ..parallel.mesh import axis_names, axis_size

    mesh, particle_axis = layout.mesh, layout.particle_axis
    stages, rows = axis_size(mesh, layout.pipe_axis), axis_size(mesh, layout.data_axis)
    if t % stages:
        raise ValueError(f"a pipelined bundle needs T ({t}) divisible by the stage count "
                         f"({stages}): export an exportable T")
    steps, rows = t // stages, n // rows // layout.micro
    defn = filter_model.definition
    if hasattr(defn, "fused_step"):  # per-step chunks, as the live pipeline runs them
        defn = dataclasses.replace(defn, fused_step=False)
    device = filter_model.device
    cols, chunk_draws = None, []
    if particle_axis is not None:
        m, shards = defn.num_particles(False), axis_size(mesh, particle_axis)
        if m % shards:
            raise ValueError(f"M={m} particles do not split over the {shards}-way "
                             f"{particle_axis!r} axis")
        cols = m // shards
    for kind, shape in draws["loop"]:
        per_row = shape[1] // n
        if particle_axis is not None and kind == "normal":  # the block's particles
            per_row //= axis_size(mesh, particle_axis)
        chunk_draws.append(torch.zeros([steps, rows * per_row] + shape[2:], device=device))
    if particle_axis is not None:  # the block's place on the axis
        chunk_draws.append(torch.zeros((), device=device))
    record = {"axes": list(axis_names(mesh)), "shape": list(mesh.mesh.shape),
              "pipe_axis": layout.pipe_axis, "data_axis": layout.data_axis,
              "particle_axis": particle_axis,
              "groups": ({particle_axis: collectives.group_name(mesh, particle_axis)}
                         if particle_axis is not None else {}),
              "stages": stages, "microbatches": layout.micro}
    return record, {"defn": defn, "steps": steps, "rows": rows, "cols": cols,
                    "draws": chunk_draws}


# ---------------------------------------------------------------------------
# Load
# ---------------------------------------------------------------------------


class ServingBundle:
    """A loaded serving bundle: the ``StatefulFilter`` eval API (belief,
    ``initialize_beliefs``, ``forward_loop``, seeded draws) run by the
    exported programs alone."""

    def __init__(self, path: str, seed: int = 0):
        with open(os.path.join(path, META)) as f:
            self.meta = json.load(f)
        if self.meta["format"] != _FORMAT_VERSION:
            raise ValueError(f"serving bundle format {self.meta['format']} != "
                             f"supported {_FORMAT_VERSION}")
        self.device = torch.device(self.meta["device"])
        if self.device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(f"{path} was exported for CUDA, which is not available "
                                   "here; export a bundle on the CPU to serve there")
            # This process's card (a rank's own): the programs create
            # tensors on the card they were traced on, so they move here.
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.init_program = self._load_program(os.path.join(path, INIT))
        self.loop_program = self._load_program(os.path.join(path, LOOP))
        self.params = torch.load(os.path.join(path, PARAMS), weights_only=True,
                                 map_location=self.device)
        # StatefulFilter's draws: one generator on the device, seeded so.
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self._leaves = None
        self._mesh = None
        pipeline = self.meta.get("pipeline")
        if pipeline is not None:
            from ..parallel.mesh import create_mesh

            self._mesh = create_mesh(axis_names=pipeline["axes"], shape=pipeline["shape"],
                                     device=self.device)
            _bind_groups(self.loop_program, pipeline, self._mesh)

    def _load_program(self, path: str):
        program = torch.export.load(path)
        if self.device.type == "cuda":
            from torch.export.passes import move_to_device_pass

            cards = {f"cuda:{i}": str(self.device) for i in range(torch.cuda.device_count())}
            program = move_to_device_pass(program, {"cuda": str(self.device), **cards})
        return program.module()

    @property
    def state_dim(self) -> int:
        return int(self.meta["state_dim"])

    @property
    def belief(self):
        if self._leaves is None:
            return None
        return _rebuild(self.meta["belief"], iter(self._leaves))

    def _input(self, x, spec, name: str):
        """x as float32 on the bundle's device; ValueError unless its shape
        is the exported one."""
        if isinstance(spec, dict):
            if not isinstance(x, dict) or set(x) != set(spec):
                raise ValueError(f"{name} must be a dict with keys {sorted(spec)}")
            return {k: self._input(x[k], spec[k], f"{name}[{k!r}]") for k in spec}
        # Contiguous: the programs were traced on contiguous inputs.
        x = torch.as_tensor(x, dtype=torch.float32, device=self.device).contiguous()
        if list(x.shape) != spec[0]:
            raise ValueError(f"{name} must be {tuple(spec[0])} (the exported shape), "
                             f"got {tuple(x.shape)}")
        return x

    def _draw(self, specs):
        return [_DRAWS[kind](shape, generator=self.generator, dtype=torch.float32,
                             device=self.device) for kind, shape in specs]

    def initialize_beliefs(self, *, mean, covariance):
        mean = self._input(mean, self.meta["mean_spec"], "mean")
        covariance = self._input(covariance, self.meta["covariance_spec"], "covariance")
        self._leaves = self.init_program(self.params, mean, covariance,
                                  *self._draw(self.meta["init_draws"]))

    def forward_loop(self, *, observations, controls):
        if self._leaves is None:
            raise RuntimeError("Call initialize_beliefs first")
        observations = self._input(observations, self.meta["observations_spec"],
                                   "observations")
        controls = self._input(controls, self.meta["controls_spec"], "controls")
        draws = self._draw(self.meta["loop_draws"])
        if self._mesh is not None:
            self._leaves, estimates = self._pipelined_loop(observations, controls, draws)
            return estimates
        self._leaves, estimates = self.loop_program(self.params, self._leaves, observations,
                                             controls, *draws)
        return estimates

    def _pipelined_loop(self, observations, controls, draws):
        """The pipeline's schedule around the exported chunk program: this
        rank's rows (data axis) and particle block (particle axis), its
        stage's time chunk, each microbatch's rows of the global draws (a
        normal draw holds a row's particles together, a uniform draw a row's
        slots or its offset), as the live loop takes them; the estimates and
        the final belief gathered over the particle and data axes."""
        from ..parallel import collectives
        from ..parallel.mesh import axis_index, axis_size, block
        from ..parallel.schedule import run_schedule

        pipeline, mesh = self.meta["pipeline"], self._mesh
        t, n = controls.shape[:2]
        pipe, data = pipeline["pipe_axis"], pipeline["data_axis"]
        particle = pipeline.get("particle_axis")
        rows = block(n, mesh, data)
        t_loc = t // axis_size(mesh, pipe)
        span = slice(axis_index(mesh, pipe) * t_loc, (axis_index(mesh, pipe) + 1) * t_loc)
        observations = {k: v[span, rows] for k, v in observations.items()}
        controls = controls[span, rows]
        draws = [d[span].reshape((t_loc, n, -1) + tuple(d.shape[2:]))[:, rows] for d in draws]
        leaves = [x[rows] for x in self._leaves]
        extra = ()
        if particle is not None:
            cols = block(leaves[0].shape[1], mesh, particle)
            draws[0] = draws[0][:, :, cols]  # the block's particles' noise
            leaves = [x[:, cols] for x in leaves]
            extra = (torch.tensor(float(axis_index(mesh, particle)), device=self.device),)
        per_call = collections.Counter(
            {(op, axis): count for op, axis, count in pipeline.get("collectives", [])})

        def run_chunk(mine, mb):
            chunk_draws = [d[:, mb].reshape((t_loc, -1) + tuple(d.shape[3:])) for d in draws]
            leaves, est = self.loop_program(
                self.params, tuple(mine), {k: v[:, mb].contiguous() for k, v in
                                           observations.items()},
                controls[:, mb].contiguous(), *chunk_draws, *extra)
            collectives.counts.update(per_call)
            return list(leaves), est

        with torch.no_grad():
            final, est = run_schedule(mesh, pipe, pipeline["microbatches"], leaves, run_chunk,
                                      train=False)
            est = collectives.all_gather(est, mesh, data, dim=1)
            if particle is not None:
                final = [collectives.all_gather(x, mesh, particle, dim=1) for x in final]
            final = [collectives.all_gather(x, mesh, data) for x in final]
        return final, est


def _bind_groups(program, pipeline, mesh) -> None:
    """Point the collectives of a pipelined bundle's chunk `program` at this
    rank's process groups of the rebuilt `mesh`. The program names each
    group as the exporting rank named it, which the meta records by axis
    (``groups``); names differ between processes and ranks, so each is
    replaced by this rank's group of the same axis. Raises ValueError where
    the program holds collectives over a group the meta does not record, or
    where an axis's collectives in the program are not those the meta
    counts."""
    from ..parallel.collectives import group_name

    recorded = pipeline.get("groups", {})
    axis_of = {name: axis for axis, name in recorded.items()}
    want = collections.Counter()
    for _, axis, count in pipeline.get("collectives", []):
        want[axis] += count
    found, unknown = collections.Counter(), []
    for node in program.graph.nodes:
        target = node.target
        if (node.op != "call_function" or getattr(target, "namespace", None) != "_c10d_functional"
                or "wait" in target.__name__):
            continue
        index = [a.name for a in target._schema.arguments].index("group_name")
        axis = axis_of.get(node.args[index])
        if axis is None:
            unknown.append((str(target), node.args[index]))
            continue
        found[axis] += 1
        node.update_arg(index, group_name(mesh, axis))
    for axis in sorted(set(want) | set(found)):
        if found[axis] != want[axis]:
            raise ValueError(
                f"the bundle's {axis!r} axis: its program holds {found[axis]} collectives "
                f"over the recorded group {recorded.get(axis)!r} and its meta counts "
                f"{want[axis]} a call: the program and the meta do not match")
    if unknown:
        raise ValueError(f"the bundle's program runs collectives over process groups its "
                         f"meta records for no axis (recorded {recorded}): {unknown}")
    program.recompile()


def load_serving_bundle(path: str, seed: int = 0) -> ServingBundle:
    return ServingBundle(path, seed=seed)
