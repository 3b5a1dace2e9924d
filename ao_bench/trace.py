"""A profiler trace of part of the window, reduced to what the per-layer
readers and the result's breakdown need.

The trace is ``torch.profiler``'s (CUPTI) over one whole episode, ended
by a device synchronize.  On a card it records the device activity and
the CUDA runtime calls only: recording the host's operators as well
slows the host, which then lets the card idle, so the idle share would
measure the profiler.  What remains still costs the host a few
microseconds a launch, which shows as idle where the host only just
keeps ahead of the card.  Device busy time is the union of the intervals
in which a kernel, copy or fill ran, not a sum of their durations.
"""

from __future__ import annotations

import json
import os
import tempfile
import time
from dataclasses import dataclass, field

import torch
from torch.profiler import ProfilerActivity, profile

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
TOP = 10


@dataclass
class Trace:
    """Device and host events of the traced part, times in seconds."""

    window_s: float
    steps: int
    counters: dict
    kernels: list = field(default_factory=list)   # (name, start, dur)
    device: list = field(default_factory=list)    # every device op
    host: list = field(default_factory=list)      # runtime calls

    def busy_intervals(self) -> list:
        """Merged (start, end) intervals in which the device ran."""
        spans = sorted((s, s + d) for _, s, d in self.device)
        merged = []
        for s, e in spans:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return merged

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals())

    def kernel_seconds(self, match) -> tuple[float, int]:
        """(summed time, count) of the kernels whose name ``match``
        accepts."""
        hits = [d for n, _, d in self.kernels if match(n)]
        return sum(hits), len(hits)

    def breakdown(self) -> dict:
        """The device operations that took most time and the longest
        idle gaps, each named by the CUDA runtime call that the host was
        in at the gap's middle and by the device operation that ended
        the gap."""
        by_name: dict = {}
        for n, _, d in self.device:
            by_name[n] = by_name.get(n, 0.0) + d
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
        busy = self.busy_intervals()
        gaps = sorted(((busy[i + 1][0] - busy[i][1], busy[i][1],
                        busy[i + 1][0]) for i in range(len(busy) - 1)),
                      reverse=True)[:TOP]
        return {"device_ops": [[n[:160], d] for n, d in ops],
                "idle_gaps": [[self.gap_name(t + g / 2, end), g]
                              for g, t, end in gaps]}

    def gap_name(self, t: float, end: float) -> str:
        """The innermost runtime call running at time t, and the device
        operation that starts at ``end``."""
        best = None
        for n, s, d in self.host:
            if s <= t <= s + d and (best is None or d < best[1]):
                best = (n, d)
        call = "host code between CUDA calls" if best is None else best[0]
        after = next((n for n, s, _ in self.device if s == end), "?")
        return f"{call[:60]}, then {after}"[:160]


def traced(fn, steps: int, counters) -> tuple:
    """Run ``fn()`` under the profiler, ended by a synchronize; returns
    (its result, Trace).  ``counters()`` reads the program's launch
    counters, taken before and after."""
    if torch.cuda.is_available():
        activities = [ProfilerActivity.CUDA]
        torch.cuda.synchronize()
    else:
        activities = [ProfilerActivity.CPU]
    before = counters()
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        out = fn()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        window = time.perf_counter() - t0
    after = counters()
    tr = Trace(window_s=window, steps=steps,
               counters={k: after[k] - before[k] for k in after})
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    for ev in events:
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        item = (str(ev.get("name", "")), float(ev["ts"]) * 1e-6,
                float(ev["dur"]) * 1e-6)
        cat = ev.get("cat", "")
        if cat in DEVICE_CATS:
            tr.device.append(item)
            if cat == "kernel":
                tr.kernels.append(item)
        elif cat in ("cuda_runtime", "cuda_driver"):
            tr.host.append(item)
    return out, tr
