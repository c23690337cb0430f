"""The port's spans (``utils/debug.py::span``) and the benchmark's readers
of them (``portbench/spans.py``, ``portbench/layer_metrics/``).

On the CPU: the door crossmodal PF's loop emits its ``mmf.*`` ranges under
``torch.profiler`` with the nesting the readers rely on, per step and on
the fused route; with no profiler it never enters ``record_function``; no
span enters a traced program; the readers give hand-computed numbers on a
hand-built trace, and nothing on a trace without spans. One test, marked
``gpu``, holds the spans and the kernels to one clock on a card: every B1
launch lies under ``mmf.pf.tail`` and B3's under ``mmf.fused.launch``.

This file imports only torch, the port and the benchmark, so the card test
also runs on a machine without JAX: ``python -m pytest --noconftest -p
no:cacheprovider tests/test_torch_port_spans.py``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile
from pathlib import Path

import pytest
import torch
from torch.fx.experimental.proxy_tensor import make_fx

from multimodalfilter_tpu_torch.crossmodal.door_models import DoorCrossmodalParticleFilter
from multimodalfilter_tpu_torch.utils import debug
from portbench import spans
from portbench import trace as trace_mod
from portbench.harness import ReaderContext, load_file_module

N, T, M = 2, 3, 8
ROOT = Path(__file__).resolve().parents[1]
ROUTES = [pytest.param(False, id="per_step"), pytest.param(True, id="fused")]


@pytest.fixture(scope="module")
def models():
    """The door crossmodal PF on the CPU at M = 8, per step and fused."""
    model = DoorCrossmodalParticleFilter(device="cpu", seed=0)
    model.eval()
    base = dataclasses.replace(model.definition, num_particles_eval=M)
    return model, {fused: dataclasses.replace(base, fused_step=fused) for fused in (False, True)}


def _inputs(device="cpu", n=N):
    g = torch.Generator(device=device).manual_seed(0)
    obs = {"image": torch.randn(T, n, 32, 32, generator=g, device=device),
           "gripper_pos": torch.randn(T, n, 3, generator=g, device=device),
           "gripper_sensors": torch.randn(T, n, 7, generator=g, device=device)}
    controls = torch.randn(T, n, 7, generator=g, device=device)
    mean = torch.zeros(n, 3, device=device)
    cov = 0.1 * torch.eye(3, device=device).expand(n, 3, 3)
    return obs, controls, mean, cov


def _request(model, inputs):
    obs, controls, mean, cov = inputs
    model.initialize_beliefs(mean=mean, covariance=cov)
    return model.forward_loop(observations=obs, controls=controls)


def _events(prof) -> list:
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]
    finally:
        os.unlink(path)


def _mmf_ranges(events) -> list:
    """(name, start, end) of every ``mmf.*`` range, by start."""
    return sorted((e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                  for e in events if e.get("ph") == "X" and e.get("name", "").startswith("mmf.")
                  and e.get("cat") == "user_annotation")


def _within(inner, outer) -> bool:
    return outer[1] <= inner[1] and inner[2] <= outer[2]


@pytest.mark.parametrize("fused", ROUTES)
def test_a_traced_loop_emits_its_spans(models, fused):
    model, defs = models
    model.definition = defs[fused]
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _request(model, _inputs())
    ranges = _mmf_ranges(_events(prof))
    by_name = {}
    for r in ranges:
        by_name.setdefault(r[0], []).append(r)
    assert {r[0] for r in ranges} <= set(debug.SPANS)
    (init,) = by_name[debug.SPAN_FACADE_INITIALIZE]
    (loop,) = by_name[debug.SPAN_FACADE_FORWARD_LOOP]
    assert init[2] <= loop[1]
    (encode,) = by_name[debug.SPAN_PF_ENCODE]
    assert _within(encode, loop)
    if fused:
        assert debug.SPAN_PF_STEP not in by_name
        (pack,) = by_name[debug.SPAN_FUSED_PACK]
        (launch,) = by_name[debug.SPAN_FUSED_LAUNCH]
        assert encode[2] <= pack[1] and pack[2] <= launch[1] and _within(launch, loop)
        return
    assert debug.SPAN_FUSED_PACK not in by_name and debug.SPAN_FUSED_LAUNCH not in by_name
    steps = by_name[debug.SPAN_PF_STEP]
    assert len(steps) == T and all(_within(s, loop) and encode[2] <= s[1] for s in steps)
    stages = (debug.SPAN_PF_DYNAMICS, debug.SPAN_PF_MEASUREMENT, debug.SPAN_PF_TAIL)
    for step in steps:
        inside = [r for r in ranges if r is not step and _within(r, step)]
        assert [r[0] for r in inside] == list(stages)  # one of each, in order


@pytest.mark.parametrize("fused", ROUTES)
def test_no_profiler_enters_no_record_function(models, monkeypatch, fused):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered with no profiler running")

    model, defs = models
    model.definition = defs[fused]
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert not torch._C._autograd._profiler_enabled()
    estimates = _request(model, _inputs())
    assert estimates.shape == (T, N, 3) and bool(torch.isfinite(estimates).all())


@pytest.mark.parametrize("fused", ROUTES)
def test_no_span_enters_a_traced_program(models, fused):
    model, defs = models
    definition = defs[fused]
    obs, controls, mean, cov = _inputs()
    obs, controls = {k: v[:1] for k, v in obs.items()}, controls[:1]  # one step traces fast
    belief = definition.initialize_beliefs(mean, cov, train=False,
                                           generator=torch.Generator().manual_seed(0))
    eps_seq = torch.randn(1, N * M, 3)
    uniforms_seq = torch.rand(1, N, M)

    def loop(particles, log_weights, obs, controls, eps_seq, uniforms_seq):
        _, estimates = definition.forward_loop(
            type(belief)(particles, log_weights), obs, controls, train=False,
            eps_seq=eps_seq, uniforms_seq=uniforms_seq)
        return estimates

    # A profiler runs while the tracer does: only the tracer guard keeps
    # the ranges out of the graph.
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        graph = make_fx(loop)(*belief, obs, controls, eps_seq, uniforms_seq)
    targets = [str(node.target) for node in graph.graph.nodes]
    assert not [t for t in targets if "profiler" in t or "record_function" in t]
    op = "mmf_torch.fused_forward" if fused else "mmf_torch.pf_tail"
    assert sum(op in t for t in targets) == 1  # the kernel's op, which the graph keeps


@pytest.mark.parametrize("attr", [a for a in dir(debug) if a.startswith("SPAN_")])
def test_the_readers_names_are_the_programs(attr):
    name = getattr(debug, attr)
    assert getattr(spans, attr[len("SPAN_"):]) == name
    assert name in spans.NAMES and name in debug.SPANS and name.startswith(spans.PREFIX)
    assert len(spans.NAMES) == len(debug.SPANS) == len(set(debug.SPANS))


# A hand-built traced segment (times in us): the window 0-100 on thread 1;
# the facade 0-10 and 10-90, holding the encoder pass 12-30 and two steps
# 30-50 (its three stages inside) and 50-70, and an operator 72-75. Kernels
# launched at 13 and 20 (inside the encoder pass), 46 (inside the tail) and
# 80 run 15-25, 25-40, 60-62 and 85-88. Another thread's step is not read.
def _x(name, ts, dur, cat="user_annotation", tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid,
            "args": args}


def _hand_built_events(with_spans=True):
    events = [_x(trace_mod.WINDOW_NAME, 0, 100), _x("aten::addmm", 72, 3, cat="cpu_op")]
    for corr, (launch, start, dur) in enumerate([(13, 15, 10), (20, 25, 15), (46, 60, 2),
                                                 (80, 85, 3)]):
        events += [_x("cudaLaunchKernel", launch, 1, cat="cuda_runtime", correlation=corr),
                   _x(f"kernel{corr}", start, dur, cat="kernel", tid=7, correlation=corr)]
    if with_spans:
        events += [_x(name, ts, dur) for name, ts, dur in [
            (spans.FACADE_INITIALIZE, 0, 10), (spans.FACADE_FORWARD_LOOP, 10, 80),
            (spans.PF_ENCODE, 12, 18), (spans.PF_STEP, 30, 20), (spans.PF_DYNAMICS, 31, 4),
            (spans.PF_MEASUREMENT, 35, 10), (spans.PF_TAIL, 45, 4), (spans.PF_STEP, 50, 20)]]
        events.append(_x(spans.PF_STEP, 0, 100, tid=2))
    return events


def _count(trace, span_name: str) -> int:
    return sum(name == span_name and tid == trace.main_tid
               for name, _, _, tid in trace.host_ops)


@pytest.mark.parametrize("names,expected", [
    pytest.param(spans.FACADE, 10 + (80 - 18 - 20 - 20), id="facade"),
    pytest.param({spans.PF_STEP}, (20 - 4 - 10 - 4) + 20, id="steps"),
    pytest.param({spans.PF_TAIL}, 4, id="tail"),
])
def test_self_time_of_a_span_set(names, expected):
    assert spans.self_time(trace_mod.Trace(_hand_built_events()), names) == expected


def test_kernels_and_idle_under_spans():
    trace = trace_mod.Trace(_hand_built_events())
    assert trace.kernels_launched_under({spans.PF_ENCODE}) == (2, 25e-6)
    assert trace.kernels_launched_under({spans.PF_TAIL}) == (1, 2e-6)
    assert spans.intervals(trace, spans.STEP_LAYER) == [(30.0, 70.0)]
    # Busy 15-40, 60-62, 85-88: idle within 30-70 is 40-60 and 62-70.
    assert spans.idle_within(trace, spans.STEP_LAYER) == 20 + 8
    assert _count(trace, spans.PF_STEP) == 2


READINGS = {"facade_self_ms_per_request": 32e-3, "encode_ms_per_request": 25e-3,
            "step_host_us_per_step": 40 / 2, "step_idle_ms_per_request": 28e-3}
READERS = [pytest.param(f"{name}.{family}", value, id=f"{name}.{family}")
           for name, value in READINGS.items() for family in ("eval", "serve")]


def _read(metric, events):
    reader = load_file_module(ROOT / "portbench" / "layer_metrics" / f"{metric}.py",
                              f"test_spans_{metric}")
    ctx = ReaderContext(trace=trace_mod.Trace(events), window={},
                        work={"requests": 1, "steps": 2}, config={}, traffic={})
    return reader.read(ctx)


@pytest.mark.parametrize("metric,value", READERS)
def test_a_reader_on_a_hand_built_trace(metric, value):
    assert _read(metric, _hand_built_events()) == pytest.approx(value, rel=1e-12)


@pytest.mark.parametrize("metric,value", READERS)
def test_a_reader_finds_nothing_without_spans(metric, value):
    assert _read(metric, _hand_built_events(with_spans=False)) is None


def _launched_within(trace, kernel: str, names) -> tuple:
    """(launches of kernels named `kernel`, how many of them the main
    thread launched inside a span named in `names`)."""
    spans_iv = spans.intervals(trace, names)
    hits = [trace.launches.get(corr) for name, _, _, cat, corr in trace.device_ops
            if cat == "kernel" and kernel in name]
    under = sum(1 for h in hits if h is not None and h[1] == trace.main_tid
                and any(a <= h[0] <= b for a, b in spans_iv))
    return len(hits), under


@pytest.mark.gpu
def test_kernels_launch_under_their_spans_on_a_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    device = torch.device("cuda")
    model = DoorCrossmodalParticleFilter(device=device, seed=0)
    model.eval()
    base = dataclasses.replace(model.definition, num_particles_eval=300)
    inputs = _inputs(device, n=4)
    for fused, kernel, span_name in ((False, "pf_row_tail_kernel", spans.PF_TAIL),
                                     (True, "pf_fused_forward_kernel", spans.FUSED_LAUNCH)):
        model.definition = dataclasses.replace(base, fused_step=fused)
        _request(model, inputs)  # the build and cuDNN's first calls
        trace, _ = trace_mod.capture(lambda: _request(model, inputs), device)
        launched, under = _launched_within(trace, kernel, {span_name})
        assert launched == (1 if fused else T) and under == launched, (kernel, launched, under)
        assert _count(trace, spans.PF_STEP) == (0 if fused else T)
