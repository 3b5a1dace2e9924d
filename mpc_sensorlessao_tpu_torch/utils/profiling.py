"""Profiling and roofline utilities (port of
``mpc_sensorlessao_tpu/utils/profiling.py``).

``DEVICE_PEAKS`` holds the published peaks of the card the port runs on;
``cost`` counts the work of eager PyTorch code, the port's counterpart of
XLA's cost analysis; ``roofline_row`` places counted work done in a
measured time against the published and the measured peaks (the one
roofline of the port: ``roofline`` is ``cost``, a host-clock time and
``roofline_row``); ``cuda_time_ms`` times a call with CUDA events;
``trace`` records a ``torch.profiler`` trace; ``timed`` is a tic/toc;
``card`` names the card and its power limit.
"""

from __future__ import annotations

import math
import os
import statistics
import subprocess
import time
from contextlib import contextmanager
from dataclasses import dataclass

import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

# Published peaks for roofline normalisation (per card, dense rates).
DEVICE_PEAKS = {
    "h100_sxm": {
        "fp32_flops": 67e12,       # FP32 outside the tensor cores
        "tf32_flops": 495e12,      # tensor cores, TF32
        "bf16_flops": 989e12,      # tensor cores, bf16
        "hbm_bytes_per_s": 3.35e12,
        "source": ("published: NVIDIA H100 SXM data sheet, at the 700 W "
                   "power limit, dense (no sparsity)"),
    },
    # for callers that pass CPU tensors; no report made from it names a
    # device metric
    "cpu": {
        "fp32_flops": 5e10, "tf32_flops": 5e10, "bf16_flops": 5e10,
        "hbm_bytes_per_s": 5e10,
        "source": "nominal figures for CPU tensors, not a published peak",
    },
}
TIME_REPEATS = 5


def device_kind(device: torch.device | str | None = None) -> str:
    """The ``DEVICE_PEAKS`` row of ``device`` (default: CUDA device 0).

    A CPU device gives "cpu".  An NVIDIA card not in the table raises:
    there is no fallback row for a card whose peaks are not known.
    """
    device = torch.device("cuda", 0) if device is None else torch.device(
        device)
    if device.type == "cpu":
        return "cpu"
    if device.type != "cuda":
        raise ValueError(f"no published peaks for device type {device.type}")
    name = torch.cuda.get_device_name(device)
    if "H100" in name and ("HBM3" in name or "SXM" in name):
        return "h100_sxm"
    raise ValueError(f"no published peaks for the card '{name}'")


def nvidia_smi(*fields: str) -> str:
    """``nvidia-smi --query-gpu=<fields> --format=csv,noheader`` for the
    first card."""
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={','.join(fields)}",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return nvidia_smi("name", "power.limit")


def cuda_time_ms(fn, reps: int) -> float:
    """Median over ``TIME_REPEATS`` of the ms per call of ``fn``, each
    repeat timed with CUDA events around ``reps`` calls, after one warm-up
    call.  ``fn`` launches on the current stream of the current CUDA
    device."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(TIME_REPEATS):
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop) / reps)
    return statistics.median(times)


# aten ops by the packet name (in-place forms drop their trailing "_")
_MATMULS = {"mm", "bmm", "addmm", "baddbmm", "addbmm", "addmv", "mv", "dot"}
_ELEMENTWISE = {
    "add": 1, "sub": 1, "rsub": 1, "mul": 1, "div": 1, "neg": 1, "abs": 1,
    "pow": 1, "reciprocal": 1, "square": 1, "clamp": 1, "clamp_min": 1,
    "clamp_max": 1, "maximum": 1, "minimum": 1, "lerp": 2, "addcmul": 2,
    "addcdiv": 2}
_REDUCTIONS = {"sum", "mean", "prod", "amax", "amin", "max", "min",
               "linalg_vector_norm", "norm", "argmax", "argmin", "cumsum"}
_TRANSCENDENTALS = {"sin", "cos", "exp", "log", "tanh", "sqrt", "rsqrt"}


def _distinct_bytes(t: torch.Tensor) -> int:
    """Bytes of the distinct elements a tensor covers: an expanded
    (stride-0) dimension is read once, not once per broadcast copy."""
    n = math.prod(s for s, st in zip(t.shape, t.stride()) if st != 0)
    return n * t.element_size()


def _matmul_flops(name: str, args) -> float:
    """2 m n k real FLOPs of one product (a complex one counts four real
    products)."""
    a, b = {"mm": (0, 1), "bmm": (0, 1), "mv": (0, 1), "dot": (0, 1),
            "addmm": (1, 2), "baddbmm": (1, 2), "addbmm": (1, 2),
            "addmv": (1, 2)}[name]
    A, Bm = args[a], args[b]
    k = A.shape[-1]
    batch = A.shape[0] if A.dim() == 3 else 1
    m = A.shape[-2] if A.dim() >= 2 else 1
    n = Bm.shape[-1] if Bm.dim() >= 2 else 1
    return 2.0 * batch * m * n * k * (4 if A.is_complex() else 1)


class _CostMode(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.counts = {"flops": 0.0, "bytes_accessed": 0.0,
                       "transcendentals": 0.0}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.is_view:
            return out
        name = func.overloadpacket.__name__.rstrip("_")
        ins = [t for t in tree_flatten((args, kwargs))[0]
               if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_flatten(out)[0]
                if isinstance(t, torch.Tensor)]
        c = self.counts
        c["bytes_accessed"] += sum(_distinct_bytes(t) for t in ins + outs)
        out_n = sum(t.numel() for t in outs)
        if name in _MATMULS:
            c["flops"] += _matmul_flops(name, args)
        elif name in _ELEMENTWISE:
            c["flops"] += _ELEMENTWISE[name] * out_n
        elif name in _REDUCTIONS:
            c["flops"] += sum(t.numel() for t in ins)
        elif name in _TRANSCENDENTALS:
            c["transcendentals"] += out_n
        return out


def cost(fn, *args, **kwargs) -> tuple[dict, object]:
    """Run ``fn(*args, **kwargs)`` once and count its work, op by op.

    Returns ({"flops", "bytes_accessed", "transcendentals"}, fn's result).
    Summed over every aten op the call dispatches:

    * flops: 2 m n k for each matrix product (mm, bmm, addmm, ...; a
      complex product counts as four real ones); one per output element
      of elementwise arithmetic (two for addcmul, addcdiv, lerp); one per
      input element of a reduction.  Transcendentals are not flops.
    * bytes_accessed: every input and output tensor of each op, read or
      written once (the distinct elements of a broadcast input once);
      views move nothing and count nothing.
    * transcendentals: output elements of sin, cos, exp, log, tanh,
      sqrt, rsqrt.

    Eager PyTorch runs each op as its own kernel, so this is the traffic
    the eager code really makes.  A kernel launched through ctypes (the
    port's CUDA kernels B1-B5) dispatches no aten op and is not seen: the
    caller adds its analytic work, as for a Pallas call in the JAX
    package's roofline.
    """
    mode = _CostMode()
    with mode:
        result = fn(*args, **kwargs)
    return dict(mode.counts), result


def roofline_row(label: str, work: dict, t_iter: float, n_items: int,
                 peaks: dict | None = None,
                 device: torch.device | str | None = None) -> dict:
    """One roofline row: ``work`` (flops, bytes_accessed,
    transcendentals) done in ``t_iter`` seconds over ``n_items`` items,
    against the published peaks of ``device``'s card (``device_kind``;
    default CUDA device 0) and, given ``peaks`` (a device_peaks report's),
    the measured ceilings.  ``bound`` names the largest share -- of the
    measured ceilings when given (operations, bytes or transcendentals),
    else of the published peaks (operations or bytes: there is no
    published transcendental rate)."""
    pub = DEVICE_PEAKS[device_kind(device)]
    fps = work["flops"] / t_iter
    bps = work["bytes_accessed"] / t_iter
    tps = work["transcendentals"] / t_iter
    shares = {"operations": fps / pub["fp32_flops"],
              "bytes": bps / pub["hbm_bytes_per_s"]}
    row = {
        "label": label,
        "wall_us_per_iter": t_iter * 1e6,
        "wall_us_per_item": t_iter / n_items * 1e6,
        "flops_per_iter": work["flops"],
        "bytes_per_iter": work["bytes_accessed"],
        "transcendentals_per_iter": work["transcendentals"],
        "achieved_tflops": fps / 1e12,
        "achieved_gbps": bps / 1e9,
        "achieved_gtransc_per_s": tps / 1e9,
        "pct_published_fp32": 100 * shares["operations"],
        "pct_published_hbm": 100 * shares["bytes"],
    }
    if peaks is not None:
        shares = {"operations": fps / peaks["f32_flops"],
                  "bytes": bps / peaks["hbm_bytes_per_s"],
                  "transcendentals": tps / peaks["transc_per_s"]}
        row.update({"pct_measured_fp32": 100 * shares["operations"],
                    "pct_measured_hbm": 100 * shares["bytes"],
                    "pct_measured_transc": 100 * shares["transcendentals"]})
    bound = max(shares, key=shares.get)
    row.update({"bound": bound, "pct_of_binding_peak": 100 * shares[bound],
                "peaks": ("measured (device_peaks.py)" if peaks is not None
                          else pub["source"])})
    return row


@dataclass
class RooflineReport:
    wall_s: float
    flops: float
    bytes_accessed: float
    achieved_flops_per_s: float
    achieved_bytes_per_s: float
    flop_utilization: float       # vs the FP32 peak
    bandwidth_utilization: float
    bound: str                    # "compute" | "memory"
    peaks: str = ""               # the DEVICE_PEAKS row and its source

    def __str__(self) -> str:
        return (f"wall {self.wall_s*1e3:.2f} ms | "
                f"{self.achieved_flops_per_s/1e12:.2f} TFLOP/s "
                f"({self.flop_utilization*100:.1f}% peak) | "
                f"{self.achieved_bytes_per_s/1e9:.1f} GB/s "
                f"({self.bandwidth_utilization*100:.1f}% peak) | "
                f"{self.bound}-bound [{self.peaks}]")


def roofline(fn, *args, repeats: int = 5) -> RooflineReport:
    """Count fn(*args)'s work with ``cost``, time it (best of
    ``repeats`` after a warm-up, host clock, synchronised on a CUDA
    device), and place it with ``roofline_row`` on the published peaks of
    the device of its first tensor argument."""
    device = next((a.device for a in args if isinstance(a, torch.Tensor)),
                  None)
    if device is None:
        raise ValueError("roofline needs a tensor argument to find its "
                         "device")
    work, _ = cost(fn, *args)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    fn(*args)
    sync()
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn(*args)
        sync()
        best = min(best, time.perf_counter() - t0)
    row = roofline_row("roofline", work, best, 1, device=device)
    return RooflineReport(
        wall_s=best, flops=work["flops"],
        bytes_accessed=work["bytes_accessed"],
        achieved_flops_per_s=work["flops"] / best,
        achieved_bytes_per_s=work["bytes_accessed"] / best,
        flop_utilization=row["pct_published_fp32"] / 100,
        bandwidth_utilization=row["pct_published_hbm"] / 100,
        bound={"operations": "compute", "bytes": "memory"}[row["bound"]],
        peaks=f"{device_kind(device)}: {row['peaks']}")


@contextmanager
def trace(log_dir: str):
    """torch.profiler over the CPU and, where there is one, the CUDA
    device; yields the profiler (``key_averages()`` for sums by op and
    kernel) and writes ``<log_dir>/trace.json`` (Chrome trace format) on
    exit."""
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


@contextmanager
def timed(label: str, sink=None):
    """tic/toc equivalent (README.md:445,624) with optional sink list."""
    t0 = time.perf_counter()
    yield
    dt = time.perf_counter() - t0
    if sink is not None:
        sink.append((label, dt))
