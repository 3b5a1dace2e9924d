"""Speed-of-light accounting on one CUDA card (port of
``benchmarks/roofline.py``).

    python -m mpc_sensorlessao_tpu_torch.benchmarks.roofline [peaks.json|-] [out.json]

For each target, the achieved FLOP/s, bytes/s and transcendentals/s,
each as a share of the card's published peak (``profiling.DEVICE_PEAKS``)
and, when a peaks report of ``benchmarks/device_peaks.py`` is given, of
the ceiling measured on the card, with the bound named: operations,
bytes or transcendentals.

Targets (the JAX script's rows):
  measure_sym3  kernel B1 on fixed inputs, R=128 B=1024, R=128 B=4096
                (the bench shape) and R=512 B=256
  step          the closed-loop control step, R=128 B=4096 and R=512
                B=256, gauss_newton_iters 0 and 1
  solve_fixed   the constant-slack Newton-KKT solve, N=2, B=1024

Time: the measure and solve rows with CUDA events on fixed inputs
(``profiling.cuda_time_ms``); the step rows with the host clock around a
``montecarlo.run_batch`` of ``STEPS`` steps that ends in
``torch.cuda.synchronize()``, best of 3, divided by the steps.

Work: ``profiling.cost`` of one application (for the step, a one-step
``run_batch``), plus the analytic work of the kernel launches that the
counter cannot see (``measure_work``), as the JAX script substitutes the
Pallas kernel's work.  Prints one JSON report and writes it to
``out.json`` when a path is given.  Raises without a CUDA device, and on
a peaks report that was not measured on an NVIDIA card.
"""

from __future__ import annotations

import dataclasses
import json
import sys
import time

import numpy as np
import torch

from .. import reference_config
from ..models import pipeline
from ..ops import newton_kkt, psf_kernels
from ..parallel import montecarlo
from ..utils import profiling
from . import kernel_variants

STEPS = 25
REPEATS = 3
CROP = 2 * 15 + 1
SOLVE_B, SOLVE_N = 1024, 2
PEAK_KEYS = ("f32_flops", "hbm_bytes_per_s", "transc_per_s")


def measure_work(variant: str, R: int, w: int, B: int) -> dict:
    """Analytic work of one call of a measurement kernel on B scenarios
    of R x R phases with w x w crops and the three diversities (-a, 0,
    +a): "sym3" (B1), "sym3_thin" (B4), "general" (B2 on the three maps)
    or "unfused" (B3 on the 3 B total phases).

    flops: per scenario both DFT stages, 12 w R^2 + 12 w^2 R complex
    multiply-adds (2 real FLOPs per real multiply-add, 4 of those per
    complex one), plus the elementwise products that form the fields: 12
    R^2 for the symmetric triple (the JAX ``pallas_measure_work``), 24 R^2
    for B2's three maps by angle addition, 6 R^2 for B3's pupil products.
    transcendentals: cos and sin of every phase read, 2 R^2 per phase.
    bytes_accessed: each input read once -- the phases (B3: the 3 B
    total phases), the pupil, the diversity maps (B1, B4: cos and sin of
    a Z4; B2: of the 3 maps) and the complex (w, R) operator -- and the
    (3 B, w, w) output written once.
    """
    if variant not in ("sym3", "sym3_thin", "general", "unfused"):
        raise ValueError(f"unknown measurement variant '{variant}'")
    fields = 3 * B
    phases = fields if variant == "unfused" else B
    maps = {"sym3": 2, "sym3_thin": 2, "general": 6, "unfused": 0}[variant]
    elementwise = {"sym3": 12, "sym3_thin": 12, "general": 24,
                   "unfused": 6}[variant]
    per_scen = 2.0 * (12.0 * w * R * R + 12.0 * w * w * R)
    floats = (phases + 1 + maps) * R * R + 2 * w * R + fields * w * w
    return {"flops": B * (per_scen + elementwise * R * R),
            "bytes_accessed": 4.0 * floats,
            "transcendentals": 2.0 * phases * R * R}


def load_peaks(path: str) -> dict:
    """The ``peaks`` of a device_peaks report measured on an NVIDIA
    card; raises for any other report (a TPU's, for one)."""
    with open(path) as f:
        report = json.load(f)
    device = str(report.get("device", ""))
    if "NVIDIA" not in device:
        raise ValueError(f"{path} was measured on '{device}', not on an "
                         "NVIDIA card: its ceilings are not this port's")
    peaks = report.get("peaks", {})
    missing = [k for k in PEAK_KEYS if k not in peaks]
    if missing:
        raise ValueError(f"{path} lacks the measured ceilings {missing}")
    return peaks


def measure_row(R: int, B: int, peaks: dict | None = None) -> dict:
    """Kernel B1 on the kernel A/B's fixed inputs at (R, B)."""
    inp = kernel_variants.inputs(R, B, "cuda")
    call = kernel_variants.variants(inp)["sym3"]
    t_iter = profiling.cuda_time_ms(call, 10) * 1e-3
    row = profiling.roofline_row(f"measure_sym3_R{R}_B{B}",
                                 measure_work("sym3", R, CROP, B), t_iter, B,
                                 peaks)
    row["work_model"] = "analytic work of kernel B1 (measure_work)"
    row["harness_note"] = (
        "CUDA events around repeated calls on fixed inputs: no scan and no "
        "carry perturbation, so nothing outside the kernel is timed")
    return row


def step_row(system: pipeline.System, cfg, B: int, gn: int,
             peaks: dict | None = None) -> dict:
    """The closed-loop step at batch B with ``gn`` Gauss-Newton
    iterations (each one more measure), on ``system``'s operators."""
    cfg = cfg.replace(estimator=dataclasses.replace(
        cfg.estimator, gauss_newton_iters=gn))
    dev = system.loop.influence.device
    scen = montecarlo.make_scenarios(cfg, torch.Generator().manual_seed(1),
                                     B, device=dev)

    def run(n):
        out = montecarlo.run_batch(system.loop, system.layers, cfg, scen, n,
                                   shared_window="verified")
        torch.cuda.synchronize()
        return out

    run(STEPS)
    best = float("inf")
    for _ in range(REPEATS):
        t0 = time.perf_counter()
        run(STEPS)
        best = min(best, time.perf_counter() - t0)
    t_iter = best / STEPS
    eager, _ = profiling.cost(run, 1)
    w = 2 * system.est.crop_half + 1
    meas = measure_work("sym3", cfg.resolution, w, B)
    work = {k: eager[k] + (1 + gn) * meas[k] for k in eager}
    row = profiling.roofline_row(f"step_R{cfg.resolution}_B{B}_gn{gn}", work,
                                 t_iter, B, peaks)
    row["work_model"] = (
        "profiling.cost of a one-step run_batch (every eager aten op) plus "
        f"{1 + gn} x measure_work('sym3') for the kernel B1 launches it "
        "cannot see")
    row["harness_note"] = (f"host clock around {STEPS}-step run_batch "
                           f"calls ending in a synchronize, best of "
                           f"{REPEATS}, divided by the steps")
    return row


def solve_row(system: pipeline.System, peaks: dict | None = None) -> dict:
    """newton_kkt.solve_fixed at horizon SOLVE_N on SOLVE_B seeded (x0,
    x0_pre), w = 0."""
    B, N = SOLVE_B, SOLVE_N
    prob, op = system.loop.prob, system.loop.fixed_op
    nx = prob.A1.shape[0]
    dev = prob.A1.device
    rng = np.random.default_rng(1)
    x0, xp = (torch.as_tensor(
        (rng.normal(size=(B, nx)) * 0.3).astype(np.float32), device=dev)
        for _ in range(2))
    w = torch.zeros((B, N * nx), device=dev)

    def solve():
        return newton_kkt.solve_fixed(prob, op, x0, xp, w, horizon=N)

    t_iter = profiling.cuda_time_ms(solve, 10) * 1e-3
    work, _ = profiling.cost(solve)
    row = profiling.roofline_row(f"solve_fixed_N{N}_B{B}", work, t_iter, B,
                                 peaks)
    row["work_model"] = "profiling.cost of one call (no kernel launches)"
    row["harness_note"] = "CUDA events around repeated calls"
    return row


def bench_cfg(resolution: int):
    """reference_config cut as bench.py cuts it."""
    cfg = reference_config(resolution=resolution)
    return cfg.replace(sim=dataclasses.replace(
        cfg.sim, n_train=300, n_valid=50, n_test=STEPS))


def run(peaks: dict | None = None) -> dict:
    """Every row on CUDA device 0; the report main prints."""
    if not torch.cuda.is_available():
        raise RuntimeError("the roofline needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    psf_kernels.psf_crop_diversity_sym3.launches = 0
    rows = [measure_row(R, B, peaks)
            for R, B in ((128, 1024), (128, 4096), (512, 256))]
    builds = {}
    for R, B in ((128, 4096), (512, 256)):
        cfg = bench_cfg(R)
        t0 = time.perf_counter()
        system = pipeline.build(cfg, "cuda")
        torch.cuda.synchronize()
        builds[f"R{R}"] = time.perf_counter() - t0
        rows += [step_row(system, cfg, B, gn, peaks) for gn in (0, 1)]
        if R == 128:
            rows.append(solve_row(system, peaks))
    return {
        "what": ("Speed-of-light accounting of the port on one CUDA card: "
                 "achieved FLOP/s, bytes/s and transcendentals/s against "
                 "published peaks and measured ceilings."),
        "device": torch.cuda.get_device_name(0),
        "card": profiling.card(),
        "published_peaks": profiling.DEVICE_PEAKS[profiling.device_kind()],
        "measured_peaks": peaks,
        "build_s": builds,
        "b1_launches": psf_kernels.psf_crop_diversity_sym3.launches,
        "rows": rows,
    }


def main() -> None:
    peaks_path = sys.argv[1] if len(sys.argv) > 1 else "-"
    peaks = None if peaks_path == "-" else load_peaks(peaks_path)
    report = run(peaks)
    if len(sys.argv) > 2:
        with open(sys.argv[2], "w") as f:
            json.dump(report, f, indent=2)
            f.write("\n")
    print(json.dumps(report, indent=2))


if __name__ == "__main__":
    main()
