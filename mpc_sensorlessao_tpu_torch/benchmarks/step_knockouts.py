"""Knockout timing of the closed-loop step: which piece costs what (port
of the repository's ``benchmarks/step_knockouts.py``).

``step_breakdown`` times the stages in isolation; their sum need not be
the whole step's.  This rebuilds the composed step -- batched over the
scenarios, every flag on: line for line the fastmpc / newton_steps=1
step of the port's ``closed_loop.make_step``
(models/closed_loop.py), the "hold" cold start and the algebraic
residual RMS included -- with pieces knocked out, and times each variant
over a ``steps``-long run, so each knockout's delta is that piece's
marginal cost inside the real step.

Variants:
  full          -- replica of make_step's step (sanity: matches the
                   run_batch shared-window number of step_breakdown)
  fused_noise   -- no y_clean/noisy split: noise added inside measure,
                   exact Strehl from the noisy crop (biased ~+noise)
  no_exact      -- no exact-Strehl peak ratio (keep the clean split)
  no_rms        -- no rms_res / rms_turb pupil reductions
  no_noise      -- no per-step noise synthesis
  lean          -- measure -> estimate -> solve -> actuate only
  stacked       -- the StepOutputs telemetry, one stacked tensor a field
                   (simulate's layout; volts by dm.rad_to_volts)
  packed        -- one concatenated telemetry row a step, one stack
  gn0, gn1      -- 0 / 1 Gauss-Newton passes (each re-runs the fused PSF
                   measure once a step)
  rms_reduction -- the residual RMS by a (B, R^2) pupil reduction in
                   place of the algebraic path

Each figure is us a step per scenario: the median of
profiling.TIME_REPEATS runs after a warm-up, by CUDA events around each
run on the card (profiling.cuda_times_ms), by the host clock on the CPU.
``device`` is the card's name and power limit.  TF32 stays off.

Usage: python -m mpc_sensorlessao_tpu_torch.benchmarks.step_knockouts
       [R] [B] [STEPS] [variant,variant,...]
Env:   SK_DEVICE=cuda (the card unless "cpu" is named)
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np
import torch

from ..models import closed_loop, dm, estimator, mpc, pipeline
from ..ops import newton_kkt, phase_screens, zernike
from . import _protocol as P
from .step_breakdown import step_cfg, us_per_step

VARIANTS = {
    "full": dict(),
    "fused_noise": dict(clean_split=False),
    "no_exact": dict(exact_strehl=False),
    "no_rms": dict(rms=False),
    "no_noise": dict(noise_on=False),
    "lean": dict(clean_split=False, exact_strehl=False, rms=False,
                 noise_on=False, telemetry=False),
    # telemetry layout A/B: one stacked tensor a field vs one packed row
    "stacked": dict(telemetry="stacked"),
    "packed": dict(telemetry="packed"),
    # each Gauss-Newton pass runs the fused PSF measure once more a step;
    # gn=0 is the reference's linear estimator (README.md:478)
    "gn0": dict(gn=0),
    "gn1": dict(gn=1),
    "rms_reduction": dict(rms="reduction"),
}


def run_variant(models, layers, cfg, mag, noise_scale, steps: int,
                start_step: float, generator=None, noise_seq=None, *,
                clean_split=True, exact_strehl=True, rms=True,
                noise_on=True, telemetry=True, gn=None) -> list:
    """``steps`` steps of the batched step with the knockout flags, over
    the scenarios of ``mag`` and ``noise_scale`` ((B,) tensors) on the
    shared window from ``start_step``; returns each step's outputs.

    With every flag on (and gn=None -> cfg) the step is
    closed_loop.make_step's fastmpc / newton_steps=1 step; its outputs
    are [u, ||x0||, ||x_pred[:nx]||, cost, rms_res, rms_turb,
    strehl_exact] (B,)-rows; telemetry="stacked" gives simulate's 11
    StepOutputs fields, "packed" them in one (B, 3 nu + nx + 7) row.
    Noise is ``noise_scale * noise_seq[:, t]`` ((B, T, p), injected)
    when given, else drawn a step from ``generator``.
    """
    if gn is None:
        gn = cfg.estimator.gauss_newton_iters
    est = models.est
    R = cfg.resolution
    nx, nu = models.influence.shape
    N = cfg.mpc.horizon
    B = mag.shape[0]
    stack = models.state_stack.reshape(nx, R * R)
    w2 = (2 * est.crop_half + 1) ** 2
    peak_dl = torch.max(est.b_s[w2:2 * w2])
    scale_b = noise_scale[:, None]
    start = np.float32(start_step)

    u1 = u2 = torch.zeros((B, nu), dtype=torch.float32, device=mag.device)
    x_pre = torch.zeros((B, nx), dtype=torch.float32, device=mag.device)
    ad_cor = u1 @ models.influence.T
    ys = []
    for idx in range(steps):
        raw = phase_screens.phase_at(layers, start + np.float32(idx), R)
        pt_unit = zernike.piston_removed_phase_masked(
            raw, models.mask, models.mask_npix)
        phase_res = (ad_cor @ stack).reshape(B, R, R)
        phase_res.addcmul_(mag[:, None, None], pt_unit)

        if not noise_on:
            noise = None
        elif noise_seq is not None:
            noise = scale_b * noise_seq[:, idx]
        else:
            noise = scale_b * estimator.sample_noise(est, generator, (B,))
        if clean_split:
            y_clean = estimator.measure(est, phase_res)
            y = y_clean if noise is None else y_clean + noise
        else:
            y = estimator.measure(est, phase_res, noise)
            y_clean = y
        if gn > 0:
            x0 = estimator.estimate_gauss_newton(
                est, y, models.state_stack, gn)
        else:
            x0 = estimator.estimate(est, y)

        hold = cfg.mpc.cold_start == "hold" and idx == 0
        x_pre_eff = x0 if hold else x_pre
        bref = mpc.b_ref(models.mats, u1, u2)
        r, c, x_free = mpc.gradient_terms(models.mats, x0, x_pre_eff, bref)
        state = newton_kkt.solve_fixed(models.prob, models.fixed_op, x0,
                                       x_pre_eff, bref, horizon=N)
        U = state.U.reshape(B, N * nu)
        u = U[:, :nu]

        outs = [u]
        if telemetry:
            x_pred = mpc.predicted_states(models.mats, U, x_free)
            outs += [torch.linalg.vector_norm(x0, dim=-1),
                     torch.linalg.vector_norm(x_pred[:, :nx], dim=-1),
                     mpc.cost(models.mats, U, r, c)]
        if rms == "reduction":
            outs += [closed_loop._pupil_rms(models, phase_res),
                     mag * closed_loop._pupil_rms(models, pt_unit)]
        elif rms:
            # simulate's algebraic residual RMS
            rms_turb = mag * closed_loop._pupil_rms(models, pt_unit)
            ct = pt_unit.reshape(-1, R * R) @ stack.T / models.mask_npix
            var_res = (rms_turb ** 2
                       + 2.0 * mag * torch.sum(ad_cor * ct, dim=-1)
                       + torch.sum((ad_cor @ models.mode_gram) * ad_cor,
                                   dim=-1)
                       - (ad_cor @ models.mode_mean) ** 2)
            outs += [torch.sqrt(torch.clamp(var_res, min=0.0)), rms_turb]
        if exact_strehl:
            outs += [y_clean[:, w2:2 * w2].amax(dim=-1) / peak_dl]
        if telemetry in ("stacked", "packed"):
            volts = dm.rad_to_volts(u, cfg.dm.coeff_a, cfg.dm.coeff_b,
                                    cfg.estimator.rad_to_nm)
            fields = (u, u - u1, volts, x0, outs[1], outs[2], outs[3],
                      outs[4], outs[5], torch.exp(-outs[4] ** 2), outs[6])
            outs = (closed_loop.StepOutputs(*fields)
                    if telemetry == "stacked" else torch.cat(
                        [u, u - u1, volts, x0,
                         torch.stack(fields[4:], dim=-1)], dim=-1))
        ys.append(outs)
        u1, u2 = u, u1
        x_pre = x0
        ad_cor = u @ models.influence.T
    if telemetry == "stacked":
        return closed_loop.StepOutputs(*(torch.stack(col, dim=1)
                                         for col in zip(*ys)))
    if telemetry == "packed":
        return torch.stack(ys, dim=1)
    return ys


def total(ys) -> torch.Tensor:
    """The sum of every output of a run (the scan's reduction)."""
    if isinstance(ys, torch.Tensor):
        return ys.sum()
    leaves = [t for y in ys for t in (y if isinstance(y, (list, tuple))
                                      else [y])]
    return sum(t.sum() for t in leaves)


def main(argv=None, env=None) -> dict:
    """Time every variant (or those of argv[3]); returns the report and
    prints it as one JSON line."""
    argv = sys.argv[1:] if argv is None else list(argv)
    env = os.environ if env is None else env
    dev = P.device(env, "SK_DEVICE")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    R = int(argv[0]) if len(argv) > 0 else 512
    B = int(argv[1]) if len(argv) > 1 else 256
    steps = int(argv[2]) if len(argv) > 2 else 25

    cfg = step_cfg(R, steps)
    system = pipeline.build(cfg, dev)
    s0 = cfg.sim.n_train + cfg.sim.n_valid
    mags = torch.full((B,), float(cfg.sim.magnification),
                      dtype=torch.float32, device=dev)
    ns = torch.ones((B,), dtype=torch.float32, device=dev)
    out = {"R": R, "B": B, "steps": steps, "device": P.device_name(dev)}

    variants = VARIANTS
    if len(argv) > 3:
        only = argv[3].split(",")
        variants = {k: v for k, v in variants.items() if k in only}
    for name, kw in variants.items():
        gen = P.generator(dev, 7)

        def run(kw=kw, gen=gen):
            return total(run_variant(system.loop, system.layers, cfg, mags,
                                     ns, steps, s0, gen, **kw))
        out[name + "_us"] = round(us_per_step(run, dev, steps, B), 2)
        print(name, out[name + "_us"], file=sys.stderr, flush=True)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
