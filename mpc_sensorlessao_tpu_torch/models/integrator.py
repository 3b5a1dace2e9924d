"""Classical AO control: TSVD calibration vault + delayed leaky integrator
(port of ``mpc_sensorlessao_tpu/models/integrator.py``).

Equivalent of the reference's bundled-but-unused OOMAO control stack:
`calibrationVault.m` (199 LoC) and `controller.m` (367 LoC) -- the
classical baseline the sensorless MPC is compared with
(benchmarks/classical_vs_mpc.py): poke-matrix calibration with
truncated-SVD inversion, and a fixed-gain closed-loop integrator with a
frame delay.

Reference semantics replicated:

* calibrationVault.m:76-78  -- command matrix  M = V diag(1/s) U'  from
  the SVD of the poke (interaction) matrix D;
* calibrationVault.m:97-125 -- three equivalent truncation controls:
  drop modes by count (`n_thresholded`), by singular-value floor
  (`threshold`), or by condition number (`cond`, drops all modes with
  s[0]/s[i] > cond);
* controller.m:8,88-89      -- integrator gain default 0.5, delay frames;
* controller.m:305-308      -- update law
  ``coefs <- coefs - gain * M * slopes[k - delay]`` (here written with a
  leak factor, leak=0 reproducing the pure integrator).

One scenario.  The sensing and the reconstruction are linear, so they
are folded once into (K, P) and (K, K) products and the per-step sensing
of the whole turbulence sequence is one GEMM; the recurrence (command,
delay line) is a Python loop over the steps on K-vectors, and the
residual RMS of every step is one more GEMM over the applied commands.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch


@dataclass(frozen=True)
class CalibrationVault:
    """TSVD pseudo-inverse of an interaction matrix (calibrationVault.m).

    M:        (n_modes, n_slopes) float32 command matrix with
              `n_thresholded` smallest singular modes zeroed.
    singular: (min(n,m),) singular values of D (descending, host).
    n_thresholded: number of truncated modes.
    """

    M: torch.Tensor
    singular: np.ndarray
    n_thresholded: int

    @property
    def cond(self) -> float:
        """Condition number of the retained subspace
        (calibrationVault.m:124-125)."""
        kept = len(self.singular) - self.n_thresholded
        return float(self.singular[0] / self.singular[kept - 1])


def calibration_vault(D: torch.Tensor, n_thresholded: int = 0,
                      threshold: float | None = None,
                      cond: float | None = None) -> CalibrationVault:
    """Build the command matrix M = V diag(1/s) U' with TSVD truncation.

    Exactly one of the three truncation controls is applied, mirroring the
    three setters of calibrationVault.m:97-125; default keeps every mode
    (calibrationVault.m:78, nThresholded=0).  Host float64 SVD (setup
    time); M is float32 on D's device.
    """
    Dn = D.detach().cpu().double().numpy()
    U, s, Vt = np.linalg.svd(Dn, full_matrices=False)
    if threshold is not None:
        n_thresholded = int(np.sum(s < threshold))      # :97-99
    elif cond is not None:
        n_thresholded = int(np.sum(s[0] / s > cond))    # :117-121
    kept = len(s) - int(n_thresholded)
    if kept <= 0:
        raise ValueError("TSVD truncation removed every mode")
    iS = np.zeros_like(s)
    iS[:kept] = 1.0 / s[:kept]
    M = (Vt.T * iS) @ U.T                               # :76-77
    return CalibrationVault(
        torch.as_tensor(M, dtype=torch.float32, device=D.device), s,
        int(n_thresholded))


class IntegratorConfig(NamedTuple):
    """controller.m knobs: gain (default 0.5, controller.m:8,89), leak
    (0 = pure integrator), delay in frames (controller.m:88)."""

    gain: float = 0.5
    leak: float = 0.0
    delay: int = 0


def closed_loop(sense_op: torch.Tensor,
                command: CalibrationVault | torch.Tensor,
                mode_stack_flat: torch.Tensor, turb_modes: torch.Tensor,
                cfg: IntegratorConfig = IntegratorConfig(),
                mask_flat: torch.Tensor | None = None,
                slope_noise: torch.Tensor | None = None):
    """Run the delayed leaky integrator over a turbulence sequence.

    Args:
      sense_op:  (n_slopes, P) linear sensing operator (e.g.
                 SHModel.slope_op): slopes = sense_op @ phi_res.
      command:   CalibrationVault or a raw (K, n_slopes) command matrix.
      mode_stack_flat: (K, P) controlled mode shapes, flattened pixels
                 (DM modal basis; the correction is -modes' c).
      turb_modes: (T, P) open-loop turbulence phase per step, flattened.
      cfg:       gain/leak/delay.
      mask_flat: optional (P,) mask; the residual RMS is taken over it
                 (pupil-only, comparable to closed_loop.StepOutputs
                 .rms_res), else over every pixel.
      slope_noise: optional (T, n_slopes) measurement noise added to the
                 slopes each step (camera noise at the slopes level);
                 None = ideal sensor.

    Returns:
      (c_acc, res_rms): (T, K) command history and (T,) residual-phase
      RMS.

    Update law controller.m:305-308 with the sign convention phi_res =
    phi_turb - modes' c, so c accumulates the modal content of the
    turbulence.  Latency convention: the command computed from frame t is
    applied from frame t+1 on (the reported residual at t uses the
    pre-update command), so cfg.delay counts EXTRA measurement-path
    frames on top of that one inherent actuation frame -- matching the
    reference controller's timing.
    """
    M = command.M if isinstance(command, CalibrationVault) else command
    K = mode_stack_flat.shape[0]
    T = turb_modes.shape[0]
    delay = int(cfg.delay)
    gain = float(np.float32(cfg.gain))
    keep = float(np.float32(1.0) - np.float32(cfg.leak))

    # fold sensing + reconstruction once: est = M sense_op phi (every step
    # in one GEMM) and the self-sensing of the correction (M sense_op
    # modes') c
    MS = M @ sense_op                                   # (K, P)
    MSB = MS @ mode_stack_flat.T                        # (K, K)
    est_turb = turb_modes @ MS.T                        # (T, K)
    if slope_noise is not None:
        est_turb = est_turb + slope_noise @ M.T         # M (s + noise)
    if mask_flat is None:
        w_rms = torch.full((mode_stack_flat.shape[1],),
                           1.0 / mode_stack_flat.shape[1],
                           dtype=torch.float32, device=M.device)
    else:
        m = mask_flat.to(torch.float32)
        w_rms = m / torch.sum(m)

    c = torch.zeros(K, dtype=torch.float32, device=M.device)
    ring = [torch.zeros_like(c) for _ in range(delay)]
    applied, c_acc = [], []
    for t in range(T):
        applied.append(c)
        est = est_turb[t] - MSB @ c                     # = M s of residual
        if delay > 0:
            ring.append(est)
            est = ring.pop(0)
        c = keep * c + gain * est                       # controller.m:308
        c_acc.append(c)
    # the step's residual uses the command APPLIED while the frame was
    # sensed (c before its update)
    res = turb_modes - torch.stack(applied) @ mode_stack_flat
    rms = torch.sqrt(torch.sum(w_rms * res * res, dim=-1))
    return torch.stack(c_acc), rms
