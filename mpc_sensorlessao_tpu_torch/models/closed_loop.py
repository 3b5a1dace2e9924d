"""Closed-loop sensorless-AO MPC simulation engine (port of
``mpc_sensorlessao_tpu/models/closed_loop.py``).

The frozen-flow turbulence is evolved inside the loop from per-layer
periodic screens, and every step runs over an explicit scenario batch:
one Python step loop over (B, ...) tensors on the models' device.

Loop step (reference: README.md:444-626):
  residual phase -> diversity PSFs + noise -> LS estimate -> b_ref ->
  QP solve (fastmpc / closed-form) -> first-stage input ->
  DM modal correction -> next-step corrected phase.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from ..ops import newton_kkt, phase_screens, zernike
from ..utils import tree
from ..utils.config import SystemConfig
from . import dm as dm_model
from . import estimator as estimator_model
from . import mpc, solvers


@dataclass(frozen=True)
class LoopModels:
    """Precomputed operators shared across scenarios (float32 tensors)."""

    est: estimator_model.EstimatorModel
    influence: torch.Tensor       # (nx, n_act)
    mats: mpc.MPCMatrices
    prob: newton_kkt.FastMPCProblem
    fixed_op: newton_kkt.FixedNewtonOperator
    state_stack: torch.Tensor     # (nx, R, R) Zernike modes excl. piston
    mask: torch.Tensor            # (R, R) bool pupil mask
    mask_npix: torch.Tensor       # 0-d
    # discrete pupil moments of the state modes, mean_pupil(Z_j Z_k) and
    # mean_pupil(Z_k), for the algebraic residual RMS (see simulate)
    mode_gram: torch.Tensor       # (nx, nx)
    mode_mean: torch.Tensor       # (nx,)


class StepOutputs(NamedTuple):
    """Per-step telemetry, (*batch, T, ...) (the reference's accumulator
    arrays, README.md:420-427,588-624)."""

    u: torch.Tensor              # applied first-stage input (nu,)
    du: torch.Tensor             # input increment
    volts: torch.Tensor          # DM voltages
    x_est: torch.Tensor          # estimated residual coefficients
    x_est_norm: torch.Tensor     # ||ad_est||
    x_pred_norm: torch.Tensor    # ||x_prev||
    cost: torch.Tensor           # J = U'HU + r'U + c
    rms_res: torch.Tensor        # true residual-phase RMS in pupil [rad]
    rms_turb: torch.Tensor       # uncorrected turbulence RMS [rad]
    strehl: torch.Tensor         # Marechal approximation exp(-sigma^2)
    # exact OTF-volume Strehl (imager.m:98-115): peak of the noiseless
    # zd=0 diversity crop over the diffraction-limited peak of b_s
    strehl_exact: torch.Tensor


def make_loop_models(basis: zernike.ZernikeBasis,
                     est: estimator_model.EstimatorModel,
                     dm_mod: dm_model.DMModel, mats: mpc.MPCMatrices,
                     prob: newton_kkt.FastMPCProblem,
                     horizon: int = 2) -> LoopModels:
    """Bundle the loop operators; the fixed Newton operator is computed in
    float64 from ``prob`` and rounded to float32 once."""
    fixed_op = newton_kkt.precompute_fixed_newton(
        tree.cast(prob, torch.float64), horizon)
    return LoopModels(
        est=est, influence=dm_mod.influence, mats=mats, prob=prob,
        fixed_op=tree.cast(fixed_op, torch.float32),
        state_stack=basis.stack[1:], mask=basis.mask,
        mask_npix=torch.tensor(float(basis.mask.sum()), dtype=torch.float32,
                               device=basis.mask.device),
        mode_gram=basis.gram[1:, 1:], mode_mean=basis.mode_mean[1:])


def _pupil_rms(models: LoopModels, phase: torch.Tensor) -> torch.Tensor:
    msk = models.mask.to(phase.dtype)
    npix = models.mask_npix
    mean = torch.sum(phase * msk, dim=(-2, -1), keepdim=True) / npix
    return torch.sqrt(torch.sum(((phase - mean) * msk) ** 2, dim=(-2, -1))
                      / npix)


def check_ported(cfg: SystemConfig, solver: str) -> None:
    """Raise for configuration branches this port does not have yet."""
    if solver in ("fastmpc_ramp", "admm"):
        raise NotImplementedError(
            f"solver '{solver}' is not ported yet (ROADMAP.md A.8)")
    if solver not in ("fastmpc", "closed_form"):
        raise ValueError(f"unknown solver '{solver}'")
    if solver == "fastmpc" and cfg.mpc.newton_steps != 1:
        raise NotImplementedError(
            "mpc.newton_steps != 1 (the general Newton solve) is not "
            "ported yet (ROADMAP.md A.8)")
    if cfg.estimator.track_gn_iters > 0:
        raise NotImplementedError(
            "estimator.track_gn_iters > 0 is not ported yet (ROADMAP.md A.7)")
    if cfg.mpc.est_gain != 1.0 or cfg.mpc.innovation_gate is not None:
        raise NotImplementedError(
            "estimator-VAR fusion (mpc.est_gain / innovation_gate) is not "
            "ported yet (ROADMAP.md A.7)")


def simulate(models: LoopModels, layers: phase_screens.FrozenFlowLayers,
             cfg: SystemConfig, generator: torch.Generator | None,
             n_steps: int, start_step=0, solver: str | None = None,
             mag=None, noise_scale=1.0,
             noise_seq: torch.Tensor | None = None) -> StepOutputs:
    """Run the closed loop for n_steps from absolute turbulence step
    ``start_step`` over a batch of scenarios.

    The batch is the broadcast of ``mag`` (default cfg.sim magnification),
    ``noise_scale``, ``start_step`` and the leading dims of ``noise_seq``;
    all scalars give the single-scenario loop with (T, ...) outputs.
    A host-number ``start_step`` is ONE turbulence window shared by every
    scenario: the screen sample and its piston removal run once per step
    and broadcast (the shared-window fast path); a (B,) tensor gives each
    scenario its own window.

    Measurement noise is ``noise_scale * noise_seq[..., t, :]`` when
    ``noise_seq`` ((*batch, T, p) or (T, p)) is given -- the injected
    sequence of the parity tests -- else drawn per step from
    ``generator`` (a torch.Generator on the models' device).
    """
    solver = solver or cfg.mpc.solver
    check_ported(cfg, solver)
    if noise_seq is not None and noise_seq.shape[-2] < n_steps:
        raise ValueError(f"noise_seq has {noise_seq.shape[-2]} rows < "
                         f"n_steps={n_steps}")
    if noise_seq is None and generator is None:
        raise ValueError("simulate needs a generator or a noise_seq")
    dev = models.influence.device
    est = models.est
    R = cfg.resolution
    nx, nu = models.influence.shape
    N = cfg.mpc.horizon

    def f32(v):
        return torch.as_tensor(v, dtype=torch.float32, device=dev)

    mag = f32(cfg.sim.magnification if mag is None else mag)
    noise_scale = f32(noise_scale)
    shared = not (isinstance(start_step, torch.Tensor) and start_step.dim())
    # float32 step arithmetic, as the JAX package's traced steps
    start = np.float32(float(start_step)) if shared else f32(start_step)
    batch = torch.broadcast_shapes(
        mag.shape, noise_scale.shape, () if shared else start.shape,
        () if noise_seq is None else noise_seq.shape[:-2])
    B = math.prod(batch)
    mag_b = mag.expand(batch).reshape(B)
    scale_b = noise_scale.expand(batch).reshape(B, 1)
    if not shared:
        start = start.expand(batch).reshape(B)
    if noise_seq is not None:
        noise_seq = f32(noise_seq)

    stack = models.state_stack.reshape(nx, R * R)
    w2 = (2 * est.crop_half + 1) ** 2
    peak_dl = torch.max(est.b_s[w2:2 * w2])
    u1 = torch.zeros((B, nu), dtype=torch.float32, device=dev)
    u2 = torch.zeros_like(u1)
    x_pre = torch.zeros((B, nx), dtype=torch.float32, device=dev)
    ad_cor = torch.zeros_like(x_pre)
    rows = []
    for idx in range(n_steps):
        # -- turbulence + correction (README.md:447-453) --
        if shared:
            raw = phase_screens.phase_at(layers, start + np.float32(idx), R)
        else:
            raw = phase_screens.phase_at(layers, start + idx, R)
        # piston removed BEFORE the mag scaling: shared across scenarios
        # in shared-window batches
        pt_unit = zernike.piston_removed_phase_masked(
            raw, models.mask, models.mask_npix)
        phase_res = (ad_cor @ stack).reshape(B, R, R)
        phase_res.addcmul_(mag_b[:, None, None], pt_unit)

        # -- estimator (README.md:457-480) --
        if noise_seq is not None:
            noise = noise_seq[..., idx, :].expand(*batch, est.n_pixels)
            noise = scale_b * noise.reshape(B, est.n_pixels)
        else:
            noise = scale_b * estimator_model.sample_noise(est, generator,
                                                           (B,))
        y_clean = estimator_model.measure(est, phase_res)
        y = y_clean + noise
        gn = cfg.estimator.gauss_newton_iters
        if gn > 0:
            x0 = estimator_model.estimate_gauss_newton(
                est, y, models.state_stack, gn)
        else:
            x0 = estimator_model.estimate(est, y)

        # -- QP assembly (README.md:483-501); "hold": first-step
        # x0_pre = x0 instead of zeros (see MPCConfig.cold_start) --
        hold = cfg.mpc.cold_start == "hold" and idx == 0
        x_pre_eff = x0 if hold else x_pre
        bref = mpc.b_ref(models.mats, u1, u2)
        r, c, x_free = mpc.gradient_terms(models.mats, x0, x_pre_eff, bref)

        # -- solve (README.md:504-570) --
        if solver == "fastmpc":
            state = newton_kkt.solve_fixed(models.prob, models.fixed_op, x0,
                                           x_pre_eff, bref, horizon=N)
            U = state.U.reshape(B, N * nu)
        else:
            U = solvers.closed_form(models.mats, r)

        # -- actuate (README.md:576-601) --
        u = U[:, :nu]
        volts = dm_model.rad_to_volts(u, cfg.dm.coeff_a, cfg.dm.coeff_b,
                                      cfg.estimator.rad_to_nm)
        x_pred = mpc.predicted_states(models.mats, U, x_free)
        cost = mpc.cost(models.mats, U, r, c)

        # pt_unit is mean-removed, so rms(phase_turb) = mag rms(pt_unit):
        # one reduction per step in shared-window batches
        rms_turb = mag_b * _pupil_rms(models, pt_unit)
        # algebraic residual RMS with p = mag pt + sum_k ad_k Z_k (both
        # zero outside the pupil, pt pupil-mean-removed):
        #   mean(p^2) = mag^2 rms(pt)^2 + 2 mag ad.ct + ad'G ad,
        #   mean(p)   = ad.mbar,  ct_k = mean_pupil(pt Z_k)
        # -- O(nx^2) per scenario instead of a (B, R^2) reduction
        ct = pt_unit.reshape(-1, R * R) @ stack.T / models.mask_npix
        var_res = (rms_turb ** 2
                   + 2.0 * mag_b * torch.sum(ad_cor * ct, dim=-1)
                   + torch.sum((ad_cor @ models.mode_gram) * ad_cor, dim=-1)
                   - (ad_cor @ models.mode_mean) ** 2)
        rms_res = torch.sqrt(torch.clamp(var_res, min=0.0))

        # exact Strehl from the zd=0 crop (the middle w^2 block of y_clean;
        # diversity order is (-a, 0, +a))
        strehl_exact = y_clean[:, w2:2 * w2].amax(dim=-1) / peak_dl
        rows.append(StepOutputs(
            u=u, du=u - u1, volts=volts, x_est=x0,
            x_est_norm=torch.linalg.vector_norm(x0, dim=-1),
            x_pred_norm=torch.linalg.vector_norm(x_pred[:, :nx], dim=-1),
            cost=cost, rms_res=rms_res, rms_turb=rms_turb,
            strehl=torch.exp(-rms_res ** 2), strehl_exact=strehl_exact))
        u1, u2 = u, u1
        x_pre = x0
        ad_cor = u @ models.influence.T

    return StepOutputs(*(
        torch.stack(col, dim=1).reshape(*batch, n_steps,
                                        *col[0].shape[1:])
        for col in zip(*rows)))


ROLLOUT_CHUNK = 32      # steps per batched window gather


def turbulence_rollout(layers: phase_screens.FrozenFlowLayers,
                       fit_full: torch.Tensor, mask: torch.Tensor,
                       mask_npix: torch.Tensor, n_steps: int,
                       resolution: int, start_step: int = 0,
                       mag: float = 1.0) -> torch.Tensor:
    """Open-loop pre-pass: frozen-flow evolution -> piston-removed phase ->
    Zernike coefficients (README.md:69-93), ROLLOUT_CHUNK steps at a time.
    Returns (n_steps, n_modes) coefficients (piston column included)."""
    dev = layers.screens.device
    R = resolution
    msk = mask.to(torch.float32)
    out = []
    for s in range(0, n_steps, ROLLOUT_CHUNK):
        steps = torch.arange(s, min(s + ROLLOUT_CHUNK, n_steps), device=dev)
        raw = phase_screens.phase_at(layers, steps + start_step, R)
        mean = torch.sum(raw * msk, dim=(-2, -1), keepdim=True) / mask_npix
        ph = (raw - mean) * msk * mag
        out.append(ph.reshape(-1, R * R) @ fit_full.T)
    return torch.cat(out)
