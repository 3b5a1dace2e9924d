"""Aggregate metrics over closed-loop telemetry (port of
``mpc_sensorlessao_tpu/utils/metrics.py``)."""

from __future__ import annotations

import math
from typing import NamedTuple

import torch


class LoopSummary(NamedTuple):
    """Settled closed-loop performance (time axis reduced)."""

    mean_rms_res: torch.Tensor
    p95_rms_res: torch.Tensor
    mean_rms_turb: torch.Tensor
    rejection: torch.Tensor        # mean_rms_turb / mean_rms_res
    mean_strehl: torch.Tensor      # Marechal exp(-sigma^2)
    min_strehl: torch.Tensor
    mean_strehl_exact: torch.Tensor  # OTF-volume Strehl (imager.m:115)
    min_strehl_exact: torch.Tensor
    mean_cost: torch.Tensor
    max_abs_u: torch.Tensor
    max_abs_du: torch.Tensor
    max_abs_volts: torch.Tensor


def percentile(x: torch.Tensor, q: float) -> torch.Tensor:
    """The q-th percentile of all of ``x``, interpolated linearly between
    the two nearest order statistics (``jnp.percentile``'s default), by
    ``kthvalue``: ``torch.quantile`` refuses inputs above 2^24
    elements."""
    flat = x.reshape(-1)
    pos = q / 100.0 * (flat.numel() - 1)
    k = math.floor(pos)
    lo = torch.kthvalue(flat, k + 1).values
    if k + 1 == flat.numel():
        return lo
    hi = torch.kthvalue(flat, k + 2).values
    return lo + (hi - lo) * (pos - k)


def summarize(outputs, settle_fraction: float = 0.5) -> LoopSummary:
    """Reduce StepOutputs over the settled tail of the time axis, from
    step ``int(T * settle_fraction)`` on; works on (T, ...)
    single-scenario or (S, T, ...) batched outputs (the time axis is
    rms_res's last dim)."""
    s = int(outputs.rms_res.shape[-1] * settle_fraction)
    res = outputs.rms_res[..., s:]
    turb = outputs.rms_turb[..., s:]
    exact = outputs.strehl_exact[..., s:]
    return LoopSummary(
        mean_rms_res=torch.mean(res),
        p95_rms_res=percentile(res, 95),
        mean_rms_turb=torch.mean(turb),
        rejection=torch.mean(turb) / torch.mean(res),
        mean_strehl=torch.mean(outputs.strehl[..., s:]),
        min_strehl=torch.min(outputs.strehl[..., s:]),
        mean_strehl_exact=torch.mean(exact),
        min_strehl_exact=torch.min(exact),
        mean_cost=torch.mean(outputs.cost[..., s:]),
        max_abs_u=torch.max(torch.abs(outputs.u)),
        max_abs_du=torch.max(torch.abs(outputs.du)),
        max_abs_volts=torch.max(torch.abs(outputs.volts)),
    )


def to_dict(summary: LoopSummary) -> dict:
    return {k: float(v) for k, v in summary._asdict().items()}
