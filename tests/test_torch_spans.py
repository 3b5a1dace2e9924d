"""The span recorder (utils/profiling.span) inside the closed loop and the
set-up: what each step and each build records, that recording changes no
output, that the stamps are on the profiler's clock, and the nvcc
counter of ops/cuda_build."""

import dataclasses
import json
import os
import statistics
import tempfile

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from mpc_sensorlessao_tpu_torch.benchmarks import roofline
from mpc_sensorlessao_tpu_torch.models import pipeline
from mpc_sensorlessao_tpu_torch.ops import cuda_build
from mpc_sensorlessao_tpu_torch.parallel import montecarlo
from mpc_sensorlessao_tpu_torch.utils import profiling

LAYERS = ["turbulence", "synthesis", "measure", "estimate", "solve",
          "telemetry"]


@pytest.fixture
def recorder():
    """Recording on, with nothing left over from before; off after."""
    profiling.take_spans()
    was = profiling.record(True)
    yield
    profiling.record(was)
    profiling.take_spans()


@pytest.fixture(scope="module")
def system32():
    cfg = roofline.bench_cfg(32)
    return cfg, pipeline.build(cfg, "cpu")


def run3(system32, gn=0):
    cfg, system = system32
    cfg = cfg.replace(estimator=dataclasses.replace(
        cfg.estimator, gauss_newton_iters=gn))
    scen = montecarlo.make_scenarios(cfg, torch.Generator().manual_seed(1),
                                     4, device="cpu")
    return montecarlo.run_batch(system.loop, system.layers, cfg, scen, 3,
                                shared_window="verified")


@pytest.mark.parametrize("gn", [0, 1])
def test_each_step_records_its_layers_in_order(system32, recorder, gn):
    """A 3-step run_batch at R=32, B=4: one episode span; each step's
    span holds the six layers in order, with the episode's id and the
    step's index; the episode's last span is the outputs' telemetry.
    With one Gauss-Newton pass, the estimate holds a measure span."""
    run3(system32, gn)
    spans = profiling.take_spans()
    episode = spans[0]
    assert episode.name == "loop.episode" and episode.parent is None
    assert all(s.episode == episode.episode for s in spans)
    steps = [s for s in spans if s.name == "loop.step"]
    assert [s.step for s in steps] == [0, 1, 2]
    assert all(s.parent is episode for s in steps)
    for step in steps:
        kids = [s for s in spans if s.parent is step]
        assert [s.name for s in kids] == LAYERS
        assert all(s.step == step.step for s in kids)
        assert all(a.end_ns <= b.start_ns for a, b in zip(kids, kids[1:]))
        assert step.start_ns <= kids[0].start_ns
        assert kids[-1].end_ns <= step.end_ns
        estimate = kids[3]
        inner = [s.name for s in spans if s.parent is estimate]
        assert inner == ["measure"] * gn
    tail = [s for s in spans if s.parent is episode and s not in steps]
    assert [s.name for s in tail] == ["telemetry"]
    assert tail[0].step is None and tail[0].start_ns >= steps[-1].end_ns


def test_spans_off_record_nothing_and_change_nothing(system32):
    """Off (the default), nothing is recorded, and the outputs equal a
    recorded run's bit for bit."""
    profiling.take_spans()
    off = run3(system32)
    assert profiling.take_spans() == []
    was = profiling.record(True)
    try:
        on = run3(system32)
    finally:
        profiling.record(was)
    assert len(profiling.take_spans()) == 2 + 3 * 7
    for a, b in zip(off, on):
        assert torch.equal(a, b)


def test_span_off_is_one_shared_context():
    profiling.take_spans()
    assert profiling.span("a") is profiling.span("b", step=3)
    with profiling.span("a") as s:
        assert s is None
    assert profiling.take_spans() == []


def test_span_stamps_bracket_the_profilers_events():
    """Under the CPU profiler (which switches spans on), each span's
    stamps enclose the record_function region inside it in the exported
    trace (ts + baseTimeNanoseconds), the median margin within 200 us:
    the span and the trace share one clock."""
    x = torch.ones((64, 64))
    with record_function("warm"):
        x @ x
    profiling.take_spans()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for i in range(5):
            with profiling.span(f"s{i}"):
                with record_function(f"r{i}"):
                    x @ x
    spans = profiling.take_spans()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            doc = json.load(f)
    base = int(doc.get("baseTimeNanoseconds", 0))
    regions = {e["name"]: e for e in doc["traceEvents"]
               if e.get("ph") == "X" and e.get("name", "").startswith("r")}
    assert [s.name for s in spans] == [f"s{i}" for i in range(5)]
    before, after = [], []
    for i, s in enumerate(spans):
        r = regions[f"r{i}"]
        start = base + r["ts"] * 1e3
        end = start + r["dur"] * 1e3
        before.append(start - s.start_ns)
        after.append(s.end_ns - end)
    assert min(before) >= 0 and min(after) >= 0, (before, after)
    assert statistics.median(before) <= 200e3
    assert statistics.median(after) <= 200e3


def test_build_records_the_setup_spans(recorder):
    """pipeline.build at R=32 records the operators, the screens, the
    rollout and the operators again, in order; the warm-start command is
    operators work too."""
    cfg = roofline.bench_cfg(32)
    system = pipeline.build(cfg, "cpu")
    pipeline.warm_start_command(system, cfg, 350)
    names = [s.name for s in profiling.take_spans()]
    assert names == ["setup.operators", "setup.screens", "setup.rollout",
                     "setup.operators", "setup.operators"]


def test_nvcc_runs_are_counted_and_cached_loads_are_not(
        tmp_path, monkeypatch, recorder):
    """cuda_build.compiles counts nvcc runs: one for a library not yet
    built, none when the cached one is reused; the first load of a
    library is a setup.kernels span."""
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(cuda_build, "nvcc_path", lambda: "nvcc")
    monkeypatch.setattr(cuda_build, "_loaded", {})

    class Done:
        returncode, stdout, stderr = 0, "", ""

    def fake_nvcc(cmd, **kw):
        open(cmd[cmd.index("-o") + 1], "wb").close()
        return Done()
    monkeypatch.setattr(cuda_build.subprocess, "run", fake_nvcc)
    monkeypatch.setattr(cuda_build.ctypes, "CDLL", lambda path: path)
    before = cuda_build.compiles
    cuda_build.load("psf_div3_sym")
    assert cuda_build.compiles == before + 1
    cuda_build._loaded.clear()
    cuda_build.load("psf_div3_sym")
    assert cuda_build.compiles == before + 1
    assert [s.name for s in profiling.take_spans()] == ["setup.kernels"] * 2

