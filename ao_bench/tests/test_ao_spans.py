"""The span readers on a small synthetic trace, worked by hand: two steps
of the six layers, one launch each, a copy before the first step that
no layer owns, and an episode-level telemetry op."""

import types

import pytest

from ao_bench import spans, yardstick
from ao_bench.harness import load_reader
from ao_bench.trace import Trace

BASE = 1_790_000_000_000_000_000       # the profiler's base, ns
MS = 1e-3
LAYER_MS = {"turbulence": 1.0, "synthesis": 0.5, "measure": 2.0,
            "estimate": 0.2, "solve": 0.1, "telemetry": 0.05}
NEW = ["turbulence.ms_per_step", "synthesis.ms_per_step",
       "measure.ms_per_step", "estimate.ms_per_step", "solve.ms_per_step",
       "telemetry.ms_per_step", "device.unattributed_pct",
       "loop.step_ms_p95", "loop.host_ms_per_step", "loop.launch_queue_ms",
       "setup.nvcc_builds"]
OLD = ["device.idle_pct", "device.launches_per_step", "measure.b1_ms",
       "measure.b1_roofline", "setup.build_s"]
# B1's kernel, which measure.b1_ms finds by name
KERNEL = {"measure": "psf_div3_sym_kernel"}


def span(name, start_ms, end_ms, parent=None, step=None):
    return types.SimpleNamespace(
        name=name, parent=parent, step=step,
        start_ns=BASE + round(start_ms * 1e6),
        end_ns=BASE + round(end_ms * 1e6))


def episode(n_steps=2, steps_ms=4.0, queue_ms=0.5):
    """(Trace, spans): host time in ms from the episode's start.  Step t
    spans [4t + 0.1, 4t + 4); its layers tile it in LAYER_MS's order,
    0.6 ms each but the last (0.9 ms); each launches one kernel 0.05 ms
    after it opens (a 0.01 ms runtime call), which starts on the device
    ``queue_ms`` after its launch or when the device is free."""
    ep = span("loop.episode", 0.0, steps_ms * n_steps + 1.5)
    recs = [ep]
    calls, device = [("cudaMemcpyAsync", 0.01, 0.002),
                     ("cudaMemcpyAsync", 0.02, 0.002)], []
    # the first copy call made no device op (as seen on the card); the
    # second copies at once
    device.append(("Memcpy DtoH (Device -> Pageable)", 0.03, 0.01))
    free = 0.04

    def launch(t, dur, name):
        nonlocal free
        calls.append(("cudaLaunchKernel", t, 0.01))
        start = max(free, t + queue_ms)
        device.append((name, start, dur))
        free = start + dur

    for t in range(n_steps):
        s0 = steps_ms * t + 0.1
        step = span("loop.step", s0, steps_ms * (t + 1), ep, t)
        recs.append(step)
        for k, (layer, dur) in enumerate(LAYER_MS.items()):
            a = s0 + 0.6 * k
            b = steps_ms * (t + 1) if layer == "telemetry" else a + 0.6
            recs.append(span(layer, a, b, step, t))
            launch(a + 0.05, dur, KERNEL.get(layer, f"k_{layer}"))
    tail = steps_ms * n_steps
    recs.append(span("telemetry", tail, tail + 1.0, ep))
    launch(tail + 0.05, 0.3, "k_stack")
    host = [(n, s * MS, d * MS) for n, s, d in calls]
    dev = [(n, s * MS, d * MS) for n, s, d in device]
    tr = Trace(window_s=(tail + 1.5) * MS, steps=n_steps,
               counters={"b1_launches": n_steps},
               kernels=[o for o in dev if not o[0].startswith("Memcpy")],
               device=dev, host=host)
    return tr, recs


def ctx_of(tr, recs):
    ctx = plain_ctx(tr)
    ctx["span_view"] = spans.make_view(tr, recs, BASE)
    return ctx


def plain_ctx(tr):
    """The harness's context of a traced run (harness.run)."""
    ctx = {"trace": tr, "traffic": {"batch": 8}, "build_s": 1.5,
           "yardstick": yardstick,
           "config": {"estimator": {"resolution": 64, "crop_half": 15,
                                    "dft_dtype": "float32"}}}
    ctx["read"] = lambda name: load_reader(name)(ctx)
    return ctx


def test_layer_times_coverage_and_queue_by_hand():
    tr, recs = episode()
    ctx = ctx_of(tr, recs)
    for layer, ms in LAYER_MS.items():
        want = ms + (0.3 / 2 if layer == "telemetry" else 0.0)
        assert load_reader(f"{layer}.ms_per_step")(ctx) == pytest.approx(
            want, abs=1e-9)
    total = 2 * sum(LAYER_MS.values()) + 0.3 + 0.01
    assert load_reader("device.unattributed_pct")(ctx) == pytest.approx(
        100 * 0.01 / total)
    # the layers plus the unattributed part give the busy time a step
    per_step = sum(load_reader(f"{k}.ms_per_step")(ctx) for k in LAYER_MS)
    assert per_step + 0.01 / 2 == pytest.approx(1e3 * tr.busy_s / 2)
    # step 0's first kernel launches at 0.15 ms and starts 0.5 ms later;
    # step 1's at 4.15 ms, on a free device, 0.5 ms later too
    assert load_reader("loop.launch_queue_ms")(ctx) == pytest.approx(0.5)


def test_host_time_outside_runtime_calls_by_hand():
    """A step's span (3.9 ms) holds six 0.01 ms launch calls."""
    tr, recs = episode()
    ctx = ctx_of(tr, recs)
    assert load_reader("loop.host_ms_per_step")(ctx) == pytest.approx(
        3.9 - 6 * 0.01)


def test_step_time_p95_by_hand():
    """Twenty steps 4 ms apart, the device never behind: every step but
    the last reads 4 ms between first kernels; the last runs from its
    first kernel's start to its last kernel's end, its kernels back to
    back."""
    tr, recs = episode(n_steps=20)
    ctx = ctx_of(tr, recs)
    v = ctx["span_view"]
    ms = v.step_ms()
    assert ms[:-1] == pytest.approx([4.0] * 19)
    assert ms[-1] == pytest.approx(sum(LAYER_MS.values()))
    assert load_reader("loop.step_ms_p95")(ctx) == pytest.approx(4.0)


def test_launches_pair_by_kind_from_the_back():
    """A surplus call of one kind (here the copy with no device op) pairs
    nothing and shifts no other kind."""
    tr, recs = episode()
    pairs = spans.pair(tr.host, tr.device)
    assert len(pairs) == len(tr.device)
    copy = [p for p in pairs if p[0][0].startswith("Memcpy")]
    assert copy == [(tr.device[0], 0.02 * MS)]
    for op, launch in pairs:
        assert launch <= op[1]


def test_innermost_open_span():
    a = (0.0, 10.0, "a")
    b = (1.0, 5.0, "b")
    c = (2.0, 3.0, "c")
    d = (6.0, 7.0, "d")
    got = spans.innermost([a, b, c, d], [2.5, 0.5, 4.0, 6.5, 8.0, 11.0])
    assert got == ["c", "a", "b", "d", "a", None]


def test_existing_readers_read_the_same_with_the_spans():
    tr, recs = episode()
    plain = plain_ctx(tr)
    before = {n: load_reader(n)(plain) for n in OLD}
    ctx = ctx_of(tr, recs)
    for n in NEW:
        load_reader(n)(ctx)
    assert {n: load_reader(n)(ctx) for n in OLD} == before
    assert before["measure.b1_ms"] == pytest.approx(2.0)


def test_no_spans_no_reading(monkeypatch):
    """An older program (no take_spans) or a trace without device
    operations gives nothing, and no reader raises."""
    tr, _ = episode()
    monkeypatch.setattr(spans, "take_program_spans", lambda: None)
    ctx = {"trace": tr}
    assert all(load_reader(n)(ctx) is None for n in NEW[:-1])
    empty = Trace(window_s=1.0, steps=2, counters={})
    assert spans.make_view(empty, [], BASE) is None
    assert load_reader("setup.nvcc_builds")({"trace": empty}) is None
