"""The benchmark's frozen arithmetic: the work of the measure kernel and
its least time on the card, the published peaks, and the divergence rule
of a Monte-Carlo batch.

These copy the port's own sound definitions so that a later change to
the program cannot move the yardstick: ``measure_work``, ``dft_flops``
and ``measure_bound`` of ``benchmarks/roofline.py`` (work from shapes,
the same whatever implements the kernel), the published H100 SXM peaks
of ``utils/profiling.DEVICE_PEAKS``, and the divergence containment of
``parallel/montecarlo.MonteCarloStats``.
"""

from __future__ import annotations

import torch

# NVIDIA H100 SXM data sheet, dense (no sparsity), at the 700 W limit
H100_PEAKS = {
    "fp32_flops": 67e12,       # FP32 outside the tensor cores
    "tf32_flops": 495e12,      # tensor cores, TF32
    "bf16_flops": 989e12,      # tensor cores, bf16
    "hbm_bytes_per_s": 3.35e12,
}
# TF32 passes of a float32-accurate product (a = hi + lo, three products)
TF32_PASSES = 3
VARIANTS = ("sym3", "sym3_thin", "general", "unfused")


def measure_work(variant: str, R: int, w: int, B: int) -> dict:
    """Work of one call of a measure kernel on B scenarios of R x R
    phases, w x w crops and the diversities (-a, 0, +a): "sym3" (B1),
    "sym3_thin" (B4), "general" (B2 on three maps) or "unfused" (B3 on
    the 3 B total phases).

    flops: both DFT stages per scenario (``dft_flops``) plus the
    elementwise forming of the fields (12, 24 or 6 R^2 a scenario);
    transcendentals: cos and sin of every phase read; bytes: every input
    read once (phases, pupil, the diversity maps, the complex (w, R)
    operator) and the (3 B, w, w) output written once, 4 bytes each.
    """
    if variant not in VARIANTS:
        raise ValueError(f"unknown measure variant {variant!r}")
    fields = 3 * B
    phases = fields if variant == "unfused" else B
    maps = {"sym3": 2, "sym3_thin": 2, "general": 6, "unfused": 0}[variant]
    elementwise = {"sym3": 12, "sym3_thin": 12, "general": 24,
                   "unfused": 6}[variant]
    floats = (phases + 1 + maps) * R * R + 2 * w * R + fields * w * w
    return {"flops": dft_flops(R, w, B) + B * elementwise * R * R,
            "bytes": 4.0 * floats,
            "transcendentals": 2.0 * phases * R * R}


def dft_flops(R: int, w: int, B: int) -> float:
    """Both DFT stages for the three diversities of B scenarios: 2 (12 w
    R^2 + 12 w^2 R) real FLOPs a scenario (4 real multiply-adds to a
    complex one, 3 fields, two stages)."""
    return B * 2.0 * (12.0 * w * R * R + 12.0 * w * w * R)


def measure_bound(variant: str, R: int, B: int, w: int,
                  bf16: bool = False) -> dict:
    """Least time [ms] of one call at the published peaks, whatever the
    kernel's design: the largest of the DFT products on the tensor cores
    (3 TF32 passes for float32 accuracy, one bf16 pass for the bf16
    branch), the rest of the FLOPs on FP32, and the bytes on HBM."""
    work = measure_work(variant, R, w, B)
    dft = dft_flops(R, w, B)
    p = H100_PEAKS
    tensor = (dft / p["bf16_flops"] if bf16
              else TF32_PASSES * dft / p["tf32_flops"])
    ms = {"tensor": 1e3 * tensor,
          "fp32": 1e3 * (work["flops"] - dft) / p["fp32_flops"],
          "bytes": 1e3 * work["bytes"] / p["hbm_bytes_per_s"]}
    limit = max(ms, key=ms.get)
    return {**{f"{k}_ms": v for k, v in ms.items()}, "bound_ms": ms[limit],
            "limit": limit}


# a settled loop whose residual is above this multiple of its own
# turbulence is injecting aberration, not correcting it
DIVERGED_REJECTION_FLOOR = 10.0


def settled_from(n_steps: int) -> int:
    """First step of the settled half of an episode."""
    return max(n_steps // 2, 1)


def kept(rms_res: torch.Tensor, rms_turb: torch.Tensor) -> torch.Tensor:
    """(B,) bool: the scenarios not diverged, from (B, T) telemetry.  A
    scenario diverged when its settled mean residual or turbulence is
    not finite, or the residual is above DIVERGED_REJECTION_FLOOR times
    its turbulence."""
    s = settled_from(rms_res.shape[1])
    res = rms_res[:, s:].double().mean(dim=1)
    turb = rms_turb[:, s:].double().mean(dim=1)
    return (torch.isfinite(res) & torch.isfinite(turb)
            & (res <= DIVERGED_REJECTION_FLOOR * turb))
