"""Closed-loop sensorless-AO MPC simulation engine (port of
``mpc_sensorlessao_tpu/models/closed_loop.py``).

The frozen-flow turbulence is evolved inside the loop -- sampled from
per-layer periodic screens, or advanced by the conditional-Gaussian flow
(ops/edge_flow.py) -- and every step runs over an explicit scenario
batch: one Python step loop over (B, ...) tensors on the models' device.

Loop step (reference: README.md:444-626):
  residual phase -> diversity PSFs + noise -> LS/MMSE estimate
  [-> tracking Gauss-Newton] [-> estimator-VAR fusion] -> b_ref ->
  QP solve (fastmpc, fixed or general Newton / fastmpc_ramp /
  closed_form / admm) -> first-stage input ->
  DM modal correction -> next-step corrected phase.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from ..ops import edge_flow, newton_kkt, phase_screens, zernike
from ..utils import profiling, tree
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


# the solver switch of MPCConfig.solver
SOLVERS = ("fastmpc", "fastmpc_ramp", "closed_form", "admm")


def check_solver(solver: str) -> None:
    """Raise ValueError for a solver name outside the switch."""
    if solver not in SOLVERS:
        raise ValueError(f"unknown solver '{solver}'")


def track_estimate(models: LoopModels, y: torch.Tensor, x0: torch.Tensor,
                   seed: torch.Tensor, sig2: torch.Tensor,
                   n_iters: int) -> torch.Tensor:
    """The tracking estimator (EstimatorConfig.track_gn_iters): full
    re-linearized Gauss-Newton from ``seed``, so the capture basin is the
    per-step innovation, not the absolute aberration.  Recovery-only
    rule: a scenario takes the tracked estimate only where the base
    estimate ``x0`` has clearly stopped explaining its measured PSFs
    (chi-square per pixel over ``sig2`` (B,) above 20 and above 3x the
    tracked one); a head-to-head chi-square pick would prefer the less
    regularized estimate, which has the larger truth error in lock.  A
    scenario whose Gauss-Newton solve failed (NaN) keeps ``x0``."""
    est, stack = models.est, models.state_stack
    x_gn = estimator_model.estimate_full_gn(est, y, stack, n_iters,
                                            x_init=seed)
    R = stack.shape[-1]
    flat = stack.reshape(stack.shape[0], R * R)

    def chi2(xc):
        phase = (xc @ flat).reshape(-1, R, R)
        with profiling.span("measure"):
            y_x = estimator_model.measure(est, phase)
        dy = y - y_x
        return torch.mean(dy * dy, dim=-1) / sig2

    c_base = chi2(x0)
    unlocked = (c_base > 3.0 * chi2(x_gn)) & (c_base > 20.0)
    return torch.where(unlocked[:, None], x_gn, x0)


def fuse_estimate(prob: newton_kkt.FastMPCProblem, x0, x_pre, x_pre2, u1,
                  u2, u3, est_gain: float,
                  gate: float | None) -> torch.Tensor:
    """Estimator-VAR fusion (MPCConfig.est_gain / innovation_gate): the
    VAR prediction of the current residual from the loop's own history,
    x[k] = A1 a[k-1] + A2 a[k-2] + B u[k-1] with a[k-j] = x[k-j] -
    B u[k-j-1], blended as x_pred + est_gain * innovation, the innovation
    clamped to norm ``gate``."""
    Bt = prob.B.T
    x_pred = ((x_pre - u2 @ Bt) @ prob.A1.T
              + (x_pre2 - u3 @ Bt) @ prob.A2.T + u1 @ Bt)
    innov = x0 - x_pred
    if gate is not None:
        nrm = torch.linalg.vector_norm(innov, dim=-1, keepdim=True)
        innov = innov * torch.clamp(gate / (nrm + 1e-12), max=1.0)
    return x_pred + est_gain * innov


def simulate(models: LoopModels, layers: phase_screens.FrozenFlowLayers,
             cfg: SystemConfig, generator: torch.Generator | None,
             n_steps: int, start_step=0, solver: str | None = None,
             mag=None, noise_scale=1.0,
             noise_seq: torch.Tensor | None = None,
             init_u: torch.Tensor | None = None,
             edge_model: edge_flow.EdgeFlowModel | None = None,
             edge_state: edge_flow.EdgeFlowState | None = None,
             turb_generator: torch.Generator | None = None,
             edge_eps: torch.Tensor | None = None,
             rows: slice | None = None) -> StepOutputs:
    """Run the closed loop for n_steps from absolute turbulence step
    ``start_step`` over a batch of scenarios.

    The batch is the broadcast of ``mag`` (default cfg.sim magnification),
    ``noise_scale``, ``start_step``, the leading dims of ``noise_seq`` and
    of ``init_u``; all scalars give the single-scenario loop with (T, ...)
    outputs.
    A host-number ``start_step`` is ONE turbulence window shared by every
    scenario: the screen sample and its piston removal run once per step
    and broadcast (the shared-window fast path); a (B,) tensor gives each
    scenario its own window.

    Measurement noise is ``noise_scale * noise_seq[..., t, :]`` when
    ``noise_seq`` ((*batch, T, p) or (T, p)) is given -- the injected
    sequence of the parity tests -- else drawn per step from
    ``generator`` (a torch.Generator on the models' device).

    ``init_u`` ((nu,) or (*batch, nu)) is the acquisition warm start
    (MPCConfig.warm_start, pipeline.warm_start_command): the DM starts
    at that command, so step 0 sees only the prediction error and its
    du is u - init_u.

    ``edge_model``/``edge_state`` switch the turbulence to the
    conditional-Gaussian flow (ops/edge_flow.advance in place of the
    periodic sample; ``layers`` is then unused and may be None).  An
    (L, n, n) state with a host-number ``start_step`` is ONE realization
    shared by every scenario, advanced once a step and broadcast (the
    edge-flow analogue of the shared window); a (B, L, n, n) state, or
    per-scenario start steps (the state is then expanded), gives each
    scenario its own flow and its own border noise.  The border noise is
    ``edge_eps`` when given -- (T, K_max+1, L, nX), or
    (*batch, T, K_max+1, L, nX) per scenario; the injected normals of
    the parity tests -- else drawn from ``turb_generator`` (default
    ``generator``).

    ``rows`` (a slice of a 1-D batch) runs only those scenarios of the
    batch, with the outputs (len(rows), T, ...): every random draw --
    the measurement noise, per-scenario border noise -- is still made
    for the whole batch and its rows kept, so a scenario's trajectory
    does not depend on which rows run beside it (the scenario-sharded
    runner, parallel/montecarlo.make_sharded_runner).
    """
    solver = solver or cfg.mpc.solver
    check_solver(solver)
    if noise_seq is not None and noise_seq.shape[-2] < n_steps:
        raise ValueError(f"noise_seq has {noise_seq.shape[-2]} rows < "
                         f"n_steps={n_steps}")
    if noise_seq is None and generator is None:
        raise ValueError("simulate needs a generator or a noise_seq")
    edge = edge_model is not None
    if edge:
        if edge_state is None:
            raise ValueError("simulate with an edge_model needs an edge_state")
        turb_generator = turb_generator or generator
        if edge_eps is None and turb_generator is None:
            raise ValueError("the conditional flow needs a turb_generator, "
                             "a generator or an edge_eps")
        if edge_eps is not None and edge_eps.shape[-4] < n_steps:
            raise ValueError(f"edge_eps has {edge_eps.shape[-4]} steps < "
                             f"n_steps={n_steps}")
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
    if init_u is not None:
        init_u = f32(init_u)
    batch = torch.broadcast_shapes(
        mag.shape, noise_scale.shape, () if shared else start.shape,
        () if noise_seq is None else noise_seq.shape[:-2],
        () if init_u is None else init_u.shape[:-1],
        () if not edge or edge_state.phases.dim() == 3
        else edge_state.phases.shape[:1],
        () if edge_eps is None else edge_eps.shape[:-4])
    B = math.prod(batch)
    if rows is not None and len(batch) != 1:
        raise ValueError(f"rows needs a 1-D batch, got {batch}")
    # every draw is the whole batch's (B_all rows); ``keep`` takes the
    # rows that run
    B_all = B
    keep = slice(None) if rows is None else rows
    B = len(range(B_all)[keep])
    mag_b = mag.expand(batch).reshape(B_all)[keep]
    scale_b = noise_scale.expand(batch).reshape(B_all, 1)[keep]
    if not shared:
        start = start.expand(batch).reshape(B_all)
    if noise_seq is not None:
        noise_seq = f32(noise_seq)
    if edge:
        phases = edge_state.phases
        edge_rows = None
        if (not shared or phases.dim() == 4
                or (edge_eps is not None and edge_eps.dim() > 4)):
            # each scenario its own flow: per-scenario start steps, a
            # batched state or per-scenario border noise
            phases = phases.expand(B_all, *phases.shape[-3:])[keep]
            turb_start = np.broadcast_to(
                np.asarray(start.cpu(), np.float32) if not shared
                else start, (B_all,))
            edge_rows = rows
        else:
            turb_start = start
        eflow = edge_flow.EdgeFlowState(phases=phases)
        if edge_eps is not None:
            edge_eps = f32(edge_eps)
            if edge_eps.dim() > 4:
                edge_eps = edge_eps.expand(
                    *batch, *edge_eps.shape[-4:]).reshape(
                        B_all, *edge_eps.shape[-4:])[keep]
    if not shared:
        start = start[keep]

    stack = models.state_stack.reshape(nx, R * R)
    w2 = (2 * est.crop_half + 1) ** 2
    peak_dl = torch.max(est.b_s[w2:2 * w2])
    # the carry of the JAX scan: u[k-1..k-3], x0[k-1..k-2] (its DM modes
    # are u[k-1]'s, made at the start of each step)
    u2 = torch.zeros((B, nu), dtype=torch.float32, device=dev)
    u3 = torch.zeros_like(u2)
    u1 = (u2 if init_u is None
          else init_u.expand(*batch, nu).reshape(B_all, nu)[keep].clone())
    x_pre = torch.zeros((B, nx), dtype=torch.float32, device=dev)
    x_pre2 = torch.zeros_like(x_pre)
    fuse = cfg.mpc.est_gain != 1.0 or cfg.mpc.innovation_gate is not None
    track = cfg.estimator.track_gn_iters
    if track > 0:
        # per-scenario noise variance, with a model-error floor that
        # keeps the chi-square meaningful in (near-)noiseless scenarios
        sig2 = ((scale_b[:, 0] * est.noise_std) ** 2
                + (1e-3 * torch.sqrt(torch.mean(est.b_s ** 2))) ** 2)
    prob = models.prob
    # the condensed QP's box and ramp bounds (ADMM); the first block's
    # ramp bounds shift by u[k-1] each step (README.md:449-451)
    U_max = torch.full((N * nu,), cfg.mpc.u_max, dtype=torch.float32,
                       device=dev)
    dU_base_max = torch.full_like(U_max, cfg.mpc.du_max)
    warmup = cfg.mpc.var_order    # steps 0..var_order have no history
    steps = []
    for idx in range(n_steps):
        with profiling.span("loop.step", step=idx):
            # -- turbulence (README.md:447-453) --
            with profiling.span("turbulence"):
                if edge:
                    eflow, raw = edge_flow.advance(
                        edge_model, eflow, turb_start + np.float32(idx),
                        turb_generator,
                        None if edge_eps is None
                        else edge_eps[..., idx, :, :, :], rows=edge_rows)
                elif shared:
                    raw = phase_screens.phase_at(
                        layers, start + np.float32(idx), R)
                if edge or shared:
                    # piston removed BEFORE the mag scaling: shared across
                    # scenarios in shared-window batches
                    pt_unit = zernike.piston_removed_phase_masked(
                        raw, models.mask, models.mask_npix)
                else:
                    pt_unit = phase_screens.piston_removed_phase_at(
                        layers, start + idx, R, models.mask,
                        models.mask_npix)
            # -- correction: the DM phase of the last command --
            with profiling.span("synthesis"):
                ad_cor = u1 @ models.influence.T
                phase_res = (ad_cor @ stack).reshape(B, R, R)
                phase_res.addcmul_(mag_b[:, None, None], pt_unit)

            # -- estimator (README.md:457-480) --
            with profiling.span("measure"):
                if noise_seq is not None:
                    noise = noise_seq[..., idx, :].expand(*batch,
                                                          est.n_pixels)
                    noise = scale_b * noise.reshape(B_all,
                                                    est.n_pixels)[keep]
                else:
                    noise = scale_b * estimator_model.sample_noise(
                        est, generator, (B_all,))[keep]
                y_clean = estimator_model.measure(est, phase_res)
                y = y_clean + noise
            with profiling.span("estimate"):
                gn = cfg.estimator.gauss_newton_iters
                if gn > 0:
                    x0 = estimator_model.estimate_gauss_newton(
                        est, y, models.state_stack, gn)
                else:
                    x0 = estimator_model.estimate(est, y)
                if track > 0:
                    # continuity seed: the last estimate moved by the
                    # applied command change
                    seed = (x0 if idx <= warmup
                            else x_pre + (u1 - u2) @ prob.B.T)
                    x0 = track_estimate(models, y, x0, seed, sig2, track)
                if fuse and idx > warmup:
                    x0 = fuse_estimate(prob, x0, x_pre, x_pre2, u1, u2, u3,
                                       cfg.mpc.est_gain,
                                       cfg.mpc.innovation_gate)

            with profiling.span("solve"):
                # -- QP assembly (README.md:483-501); "hold": first-step
                # x0_pre = x0 instead of zeros (see MPCConfig.cold_start)
                hold = cfg.mpc.cold_start == "hold" and idx == 0
                x_pre_eff = x0 if hold else x_pre
                bref = mpc.b_ref(models.mats, u1, u2)
                r, c, x_free = mpc.gradient_terms(models.mats, x0,
                                                  x_pre_eff, bref)

                # -- solve (README.md:504-570) --
                if solver == "fastmpc" and cfg.mpc.newton_steps == 1:
                    # real-time mode: the constant-slack single Newton step
                    state = newton_kkt.solve_fixed(
                        models.prob, models.fixed_op, x0, x_pre_eff, bref,
                        horizon=N)
                    U = state.U.reshape(B, N * nu)
                elif solver in ("fastmpc", "fastmpc_ramp"):
                    # the general Newton solve; fastmpc_ramp adds the
                    # VAR_1 ramp rows with each scenario's running u[k-1]
                    ramp = solver == "fastmpc_ramp"
                    p = dataclasses.replace(prob, u_prev=u1) if ramp else prob
                    state = newton_kkt.solve(p, x0, x_pre_eff, bref,
                                             horizon=N,
                                             n_newton=cfg.mpc.newton_steps,
                                             ramp=ramp)
                    U = state.U.reshape(B, N * nu)
                elif solver == "closed_form":
                    U = solvers.closed_form(models.mats, r)
                else:
                    shift = torch.nn.functional.pad(u1, (0, (N - 1) * nu))
                    U = solvers.admm_condensed(models.mats, r, -U_max, U_max,
                                               shift - dU_base_max,
                                               shift + dU_base_max)
                # -- actuate (README.md:576-601) --
                u = U[:, :nu]

            with profiling.span("telemetry"):
                volts = dm_model.rad_to_volts(u, cfg.dm.coeff_a,
                                              cfg.dm.coeff_b,
                                              cfg.estimator.rad_to_nm)
                x_pred = mpc.predicted_states(models.mats, U, x_free)
                cost = mpc.cost(models.mats, U, r, c)

                # pt_unit is mean-removed, so rms(phase_turb) = mag
                # rms(pt_unit): one reduction per step in shared-window
                # batches
                rms_turb = mag_b * _pupil_rms(models, pt_unit)
                # algebraic residual RMS with p = mag pt + sum_k ad_k Z_k
                # (both zero outside the pupil, pt pupil-mean-removed):
                #   mean(p^2) = mag^2 rms(pt)^2 + 2 mag ad.ct + ad'G ad,
                #   mean(p)   = ad.mbar,  ct_k = mean_pupil(pt Z_k)
                # -- O(nx^2) per scenario instead of a (B, R^2) reduction
                ct = pt_unit.reshape(-1, R * R) @ stack.T / models.mask_npix
                var_res = (rms_turb ** 2
                           + 2.0 * mag_b * torch.sum(ad_cor * ct, dim=-1)
                           + torch.sum((ad_cor @ models.mode_gram) * ad_cor,
                                       dim=-1)
                           - (ad_cor @ models.mode_mean) ** 2)
                rms_res = torch.sqrt(torch.clamp(var_res, min=0.0))

                # exact Strehl from the zd=0 crop (the middle w^2 block of
                # y_clean; diversity order is (-a, 0, +a))
                strehl_exact = y_clean[:, w2:2 * w2].amax(dim=-1) / peak_dl
                steps.append(StepOutputs(
                    u=u, du=u - u1, volts=volts, x_est=x0,
                    x_est_norm=torch.linalg.vector_norm(x0, dim=-1),
                    x_pred_norm=torch.linalg.vector_norm(x_pred[:, :nx],
                                                         dim=-1),
                    cost=cost, rms_res=rms_res, rms_turb=rms_turb,
                    strehl=torch.exp(-rms_res ** 2),
                    strehl_exact=strehl_exact))
            u1, u2, u3 = u, u1, u2
            x_pre, x_pre2 = x0, x_pre

    out_batch = batch if rows is None else (B,)
    with profiling.span("telemetry"):
        return StepOutputs(*(
            torch.stack(col, dim=1).reshape(*out_batch, n_steps,
                                            *col[0].shape[1:])
            for col in zip(*steps)))


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
    out = []
    for s in range(0, n_steps, ROLLOUT_CHUNK):
        steps = torch.arange(s, min(s + ROLLOUT_CHUNK, n_steps), device=dev)
        ph = phase_screens.piston_removed_phase_at(
            layers, (steps + start_step).to(torch.float32), R, mask,
            mask_npix) * mag
        out.append(ph.reshape(-1, R * R) @ fit_full.T)
    return torch.cat(out)
