"""Failure detection for closed-loop runs (port of
``mpc_sensorlessao_tpu/utils/guards.py``).

Post-hoc validation of loop telemetry (closed_loop.StepOutputs, single
scenario or batched, on any device): non-finite values, input-box and
ramp violations, divergence -- as a structured health report.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

import numpy as np
import torch


@dataclass
class HealthReport:
    ok: bool
    issues: List[str] = field(default_factory=list)

    def __str__(self) -> str:
        return "OK" if self.ok else "; ".join(self.issues)


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def check_outputs(outputs, u_max: float | None = None,
                  divergence_factor: float = 5.0,
                  du_max: float | None = None) -> HealthReport:
    """Validate loop telemetry (single scenario or batched).

    Flags NaN/Inf anywhere, input-box violations, ramp violations (if
    du_max given), and divergence (settled residual RMS exceeding
    divergence_factor x turbulence RMS).
    """
    issues = []
    for name in ("u", "x_est", "cost", "rms_res", "volts"):
        if not np.isfinite(_host(getattr(outputs, name))).all():
            issues.append(f"non-finite values in {name}")
    u = _host(outputs.u)
    if u_max is not None and np.abs(u).max() > u_max * (1 + 1e-5):
        issues.append(f"input box violated: |u|max={np.abs(u).max():.3f}")
    if du_max is not None:
        du = _host(outputs.du)
        # first step is a cold start (du = u_0)
        if np.abs(du[..., 1:, :]).max() > du_max * 1.05:
            issues.append("ramp-rate bound violated")
    res = _host(outputs.rms_res)
    turb = _host(outputs.rms_turb)
    T = res.shape[-1]
    settled_res = res[..., T // 2:].mean()
    settled_turb = turb[..., T // 2:].mean()
    if settled_res > divergence_factor * max(settled_turb, 1e-9):
        issues.append(
            f"diverged: residual {settled_res:.2f} vs turb {settled_turb:.2f}")
    return HealthReport(ok=not issues, issues=issues)
