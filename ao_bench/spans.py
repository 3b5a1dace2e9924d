"""The program's spans laid over the traced episode's device trace.

The port records a span at each layer of its closed-loop step
(``mpc_sensorlessao_tpu_torch.utils.profiling.span``) whenever a
profiler runs, so the traced episode carries them; nothing here switches
them on.  Each span is stamped with ``time.time_ns()``, the clock of the
profiler's exported trace less its ``baseTimeNanoseconds``, which this
module reads from an export of its own (the base is fixed for the
process).

A device operation belongs to the innermost span open on the host when
its launch call (``cudaLaunchKernel``, ``cuLaunchKernel`` for the ctypes
kernels B1-B5, a memcpy or memset call) started.  The trace kept by
``trace.py`` has no correlation ids, so a launch call and its operation
are paired by order: the episode runs on one stream, where operations
start in the order they were launched (``pair``).

A program that records no spans -- one older than them -- gives
nothing, and every reader then reports nothing.
"""

from __future__ import annotations

import json
import os
import statistics
import sys
import tempfile
import traceback
from dataclasses import dataclass

LAYERS = ("turbulence", "synthesis", "measure", "estimate", "solve",
          "telemetry")
PROGRAM_PROFILING = "mpc_sensorlessao_tpu_torch.utils.profiling"
KERNEL_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC",
                "cudaLaunchCooperativeKernel", "cuLaunchKernel",
                "cuLaunchKernelEx")


@dataclass
class Op:
    """One device operation with its launch call and owning span."""

    name: str
    start: float          # device start, trace seconds
    dur: float
    launch: float         # host start of its launch call, trace seconds
    layer: str | None     # the innermost span's name if it is a layer
    step: int | None      # the step of that span


@dataclass
class View:
    """The traced episode seen through the spans."""

    ops: list             # Op, in device order
    steps: list           # the loop.step spans as (start, end) seconds
    host_calls: list      # (start, end) of the runtime and driver calls

    def layer_ms_per_step(self, layer: str) -> float:
        return 1e3 * sum(o.dur for o in self.ops
                         if o.layer == layer) / len(self.steps)

    def unattributed_pct(self) -> float:
        total = sum(o.dur for o in self.ops)
        return 100.0 * sum(o.dur for o in self.ops
                           if o.layer is None) / total

    def first_ops(self) -> dict:
        """step -> the first device operation launched in it."""
        first: dict = {}
        for o in self.ops:
            if o.step is not None and o.step not in first:
                first[o.step] = o
        return first

    def step_ms(self) -> list:
        """Per step, device start of its first operation to the next
        step's; the last step to the end of its last operation."""
        first = self.first_ops()
        n = len(self.steps)
        if sorted(first) != list(range(n)):
            return []
        out = [first[t + 1].start - first[t].start for t in range(n - 1)]
        last = max(o.start + o.dur for o in self.ops if o.step == n - 1)
        out.append(last - first[n - 1].start)
        return [1e3 * v for v in out]

    def launch_queue_ms(self) -> float:
        """Median over steps of the device start less the host launch of
        each step's first operation."""
        first = self.first_ops()
        return 1e3 * statistics.median(o.start - o.launch
                                       for o in first.values())

    def host_ms_per_step(self) -> float:
        """Median over steps of the step span's length less the time in
        CUDA runtime and driver calls inside it."""
        calls = self.host_calls
        out, i = [], 0
        for s, e in self.steps:
            while i < len(calls) and calls[i][1] <= s:
                i += 1
            inside, j = 0.0, i
            while j < len(calls) and calls[j][0] < e:
                inside += min(calls[j][1], e) - max(calls[j][0], s)
                j += 1
            out.append(e - s - inside)
        return 1e3 * statistics.median(out)


def view(ctx) -> View | None:
    """The traced episode's View, made once and kept in ``ctx``; None
    without a device trace or without the program's spans.  A fault here
    is logged and gives None: a reader never stops the result line."""
    if "span_view" not in ctx:
        try:
            ctx["span_view"] = make_view(ctx["trace"])
        except Exception:   # noqa: BLE001 - the reader's boundary
            traceback.print_exc(file=sys.stderr)
            ctx["span_view"] = None
    return ctx["span_view"]


def take_program_spans() -> list | None:
    """The spans the program recorded, or None if it records none."""
    prof = sys.modules.get(PROGRAM_PROFILING)
    take = getattr(prof, "take_spans", None)
    return None if take is None else take()


def profiler_base_ns() -> int:
    """The process's ``baseTimeNanoseconds``, read from an empty export."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        pass
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "base.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            return int(json.load(f).get("baseTimeNanoseconds", 0))


def make_view(tr, spans=None, base_ns=None) -> View | None:
    if tr is None or not tr.device:
        return None
    spans = take_program_spans() if spans is None else spans
    if not spans:
        return None
    base_ns = profiler_base_ns() if base_ns is None else base_ns
    closed = [s for s in spans if s.end_ns is not None]
    steps = [s for s in closed if s.name == "loop.step"]
    if not steps:
        return None
    sec = [((s.start_ns - base_ns) * 1e-9, (s.end_ns - base_ns) * 1e-9, s)
           for s in closed]
    pairs = pair(tr.host, tr.device)
    owners = innermost(sec, [launch for _, launch in pairs])
    ops = []
    for (op, launch), span in zip(pairs, owners):
        layer = span.name if span is not None and span.name in LAYERS \
            else None
        ops.append(Op(op[0], op[1], op[2], launch, layer,
                      None if span is None else span.step))
    calls = top_level(sorted((s, s + d) for _, s, d in tr.host))
    return View(ops=ops,
                steps=[(a, b) for a, b, s in sec if s.name == "loop.step"],
                host_calls=calls)


def call_kind(name: str) -> str | None:
    if name in KERNEL_CALLS:
        return "kernel"
    if "Memcpy" in name:
        return "memcpy"
    if "Memset" in name:
        return "memset"
    return None


def op_kind(name: str) -> str:
    if name.startswith("Memcpy"):
        return "memcpy"
    if name.startswith("Memset"):
        return "memset"
    return "kernel"


def pair(host: list, device: list) -> list:
    """[(device op, host start of its launch call)] in device order.

    Launch calls and operations of each kind (kernel, memcpy, memset)
    are paired in order; calls nested in another launch call (a driver
    launch inside a runtime one) are not launches of their own."""
    calls = top_level(sorted((s, s + d, call_kind(n)) for n, s, d in host
                             if call_kind(n)))
    out = []
    for kind in ("kernel", "memcpy", "memset"):
        starts = [c[0] for c in calls if c[2] == kind]
        ops = sorted((o for o in device if op_kind(o[0]) == kind),
                     key=lambda o: o[1])
        out += align(starts, ops)
    return sorted(out, key=lambda p: p[0][1])


def align(starts: list, ops: list) -> list:
    """Pair launch-call starts with operations, both in order; where the
    counts differ, the surplus is dropped from the front."""
    k = min(len(starts), len(ops))
    return list(zip(ops[len(ops) - k:], starts[len(starts) - k:]))


def top_level(calls: list) -> list:
    """The calls (sorted by start) not nested inside an earlier one."""
    out = []
    for c in calls:
        if out and c[0] < out[-1][1]:
            continue
        out.append(c)
    return out


def innermost(spans: list, times: list) -> list:
    """For each time, the innermost of the (start, end, span) entries --
    properly nested, in start order -- open at it, or None."""
    order = sorted(range(len(times)), key=times.__getitem__)
    out = [None] * len(times)
    stack, i = [], 0
    for k in order:
        t = times[k]
        while i < len(spans) and spans[i][0] <= t:
            while stack and stack[-1][1] <= spans[i][0]:
                stack.pop()
            stack.append(spans[i])
            i += 1
        while stack and stack[-1][1] <= t:
            stack.pop()
        out[k] = stack[-1][2] if stack else None
    return out
