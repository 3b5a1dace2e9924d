"""Closed-loop sensorless-AO MPC simulation engine (port of
``mpc_sensorlessao_tpu/models/closed_loop.py``).

The frozen-flow turbulence is evolved inside the loop -- sampled from
per-layer periodic screens, or advanced by the conditional-Gaussian flow
(ops/edge_flow.py) -- and every step runs over an explicit scenario
batch: one Python step loop over (B, ...) tensors on the models' device.

Loop step (README.md:444-626; make_step's step, simulate runs it):
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


class LoopCarry(NamedTuple):
    """What one step hands the next: the JAX scan's carry, u[k-1..k-3]
    and x0[k-1..k-2] (u[k-1]'s DM modes are made at the start of each
    step), and the conditional flow's state (None on periodic screens)."""

    u1: torch.Tensor
    u2: torch.Tensor
    u3: torch.Tensor
    x_pre: torch.Tensor
    x_pre2: torch.Tensor
    flow: edge_flow.EdgeFlowState | None


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


def fuse_estimate(prob: newton_kkt.FastMPCProblem, x0, c: LoopCarry,
                  est_gain: float, gate: float | None) -> torch.Tensor:
    """Estimator-VAR fusion (MPCConfig.est_gain / innovation_gate): the
    VAR prediction of the current residual from the loop's own history,
    x[k] = A1 a[k-1] + A2 a[k-2] + B u[k-1] with a[k-j] = x[k-j] -
    B u[k-j-1], blended as x_pred + est_gain * innovation, the innovation
    clamped to norm ``gate``."""
    Bt = prob.B.T
    x_pred = ((c.x_pre - c.u2 @ Bt) @ prob.A1.T
              + (c.x_pre2 - c.u3 @ Bt) @ prob.A2.T + c.u1 @ Bt)
    innov = x0 - x_pred
    if gate is not None:
        nrm = torch.linalg.vector_norm(innov, dim=-1, keepdim=True)
        innov = innov * torch.clamp(gate / (nrm + 1e-12), max=1.0)
    return x_pred + est_gain * innov


def _turbulence(models: LoopModels, layers, R: int, shared: bool, start,
                every, rows, edge_model, edge_state, turb_generator,
                edge_eps):
    """The periodic screens or the conditional flow as (first flow state,
    ``turbulence(carry, idx) -> (flow, pt_unit)``), pt_unit piston-removed
    before the mag scaling: once a step for a shared window or flow."""
    mask, npix = models.mask, models.mask_npix
    if edge_model is None and shared:
        return None, lambda carry, idx: (
            None, zernike.piston_removed_phase_masked(phase_screens.phase_at(
                layers, start + np.float32(idx), R), mask, npix))
    if edge_model is None:      # each scenario its own window (T1)
        start = every(start, 0)
        return None, lambda carry, idx: (
            None, phase_screens.piston_removed_phase_at(
                layers, start + idx, R, mask, npix))
    phases = edge_state.phases
    if shared:
        rows = None
    else:   # each scenario its own flow and its own border noise
        phases = every(phases, 3)
        start = np.asarray(every(torch.as_tensor(start), 0, slice(None)).cpu(),
                           np.float32)
        if edge_eps is not None and edge_eps.dim() > 4:
            edge_eps = every(edge_eps, 4)
    eps_at = ((lambda idx: None) if edge_eps is None
              else (lambda idx: edge_eps[..., idx, :, :, :]))

    def turbulence(carry, idx):
        flow, raw = edge_flow.advance(edge_model, carry.flow,
                                      start + np.float32(idx), turb_generator,
                                      eps_at(idx), rows=rows)
        return flow, zernike.piston_removed_phase_masked(raw, mask, npix)
    return edge_flow.EdgeFlowState(phases=phases), turbulence


def _estimator(models: LoopModels, cfg: SystemConfig, scale_b: torch.Tensor):
    """``estimate(y, idx, carry) -> x0`` through the configured stages:
    LS / MMSE or Gauss-Newton, then tracking, then the estimator-VAR
    fusion (not in the var_order warm-up steps, which have no history)."""
    est, prob, warmup = models.est, models.prob, cfg.mpc.var_order
    gn, track = cfg.estimator.gauss_newton_iters, cfg.estimator.track_gn_iters
    base = ((lambda y: estimator_model.estimate_gauss_newton(
        est, y, models.state_stack, gn)) if gn > 0
        else (lambda y: estimator_model.estimate(est, y)))
    stages = []
    if track > 0:
        # per-scenario noise variance, with a model-error floor that
        # keeps the chi-square meaningful in (near-)noiseless scenarios
        sig2 = ((scale_b[:, 0] * est.noise_std) ** 2
                + (1e-3 * torch.sqrt(torch.mean(est.b_s ** 2))) ** 2)

        def tracked(x0, y, idx, c):
            # continuity seed: the last estimate moved by the applied
            # command change
            seed = x0 if idx <= warmup else c.x_pre + (c.u1 - c.u2) @ prob.B.T
            return track_estimate(models, y, x0, seed, sig2, track)
        stages.append(tracked)
    if cfg.mpc.est_gain != 1.0 or cfg.mpc.innovation_gate is not None:
        stages.append(lambda x0, y, idx, c: x0 if idx <= warmup else (
            fuse_estimate(prob, x0, c, cfg.mpc.est_gain,
                          cfg.mpc.innovation_gate)))

    def estimate(y, idx, carry):
        x0 = base(y)
        for stage in stages:
            x0 = stage(x0, y, idx, carry)
        return x0
    return estimate


# the solver switch of MPCConfig.solver
SOLVERS = ("fastmpc", "fastmpc_ramp", "closed_form", "admm")


def check_solver(solver: str) -> None:
    """Raise ValueError for a solver name outside the switch."""
    if solver not in SOLVERS:
        raise ValueError(f"unknown solver '{solver}'")


def _solver(models: LoopModels, cfg: SystemConfig, solver: str):
    """``solve(x0, x_pre_eff, bref, r, u1) -> U`` of the named solver
    (README.md:504-570)."""
    prob, N, n = models.prob, cfg.mpc.horizon, cfg.mpc.newton_steps
    if solver == "fastmpc" and n == 1:
        # real-time mode: the constant-slack single Newton step
        return lambda x0, x_pre_eff, bref, r, u1: newton_kkt.solve_fixed(
            prob, models.fixed_op, x0, x_pre_eff, bref, horizon=N).U
    if solver == "fastmpc":
        return lambda x0, x_pre_eff, bref, r, u1: newton_kkt.solve(
            prob, x0, x_pre_eff, bref, horizon=N, n_newton=n, ramp=False).U
    if solver == "fastmpc_ramp":
        # the VAR_1 ramp rows with each scenario's running u[k-1]
        return lambda x0, x_pre_eff, bref, r, u1: newton_kkt.solve(
            dataclasses.replace(prob, u_prev=u1), x0, x_pre_eff, bref,
            horizon=N, n_newton=n, ramp=True).U
    if solver == "closed_form":
        return lambda x0, x_pre_eff, bref, r, u1: solvers.closed_form(
            models.mats, r)
    # ADMM on the condensed QP's box and ramp bounds; the first block's
    # ramp bounds shift by u[k-1] each step (README.md:449-451)
    nu = models.influence.shape[1]
    U_max = torch.full((N * nu,), cfg.mpc.u_max, dtype=torch.float32,
                       device=models.influence.device)
    dU_base_max = torch.full_like(U_max, cfg.mpc.du_max)

    def admm(x0, x_pre_eff, bref, r, u1):
        shift = torch.nn.functional.pad(u1, (0, (N - 1) * nu))
        return solvers.admm_condensed(models.mats, r, -U_max, U_max,
                                      shift - dU_base_max,
                                      shift + dU_base_max)
    return admm


def make_step(models, layers, cfg, generator, n_steps, start_step=0,
              solver=None, mag=None, noise_scale=1.0, noise_seq=None,
              init_u=None, edge_model=None, edge_state=None,
              turb_generator=None, edge_eps=None, rows=None):
    """``simulate``'s loop (its arguments) as (first LoopCarry, ``step(
    carry, idx) -> (carry, StepOutputs)`` over the rows that run, outputs
    (B, ...), and the outputs' batch shape): the turbulence source, the
    estimator stages and the solver are chosen here, once, and all that
    changes between steps is in the carry."""
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
    dev, est, R = models.influence.device, models.est, cfg.resolution
    nx, nu = models.influence.shape

    def f32(v):
        return None if v is None else torch.as_tensor(
            v, dtype=torch.float32, device=dev)

    mag = f32(cfg.sim.magnification if mag is None else mag)
    noise_scale, init_u, noise_seq, edge_eps = map(
        f32, (noise_scale, init_u, noise_seq, edge_eps))
    host_start = not (torch.is_tensor(start_step) and start_step.dim())
    # float32 step arithmetic, as the JAX package's traced steps
    start = np.float32(float(start_step)) if host_start else f32(start_step)
    batch = torch.broadcast_shapes(
        mag.shape, noise_scale.shape, () if host_start else start.shape,
        () if noise_seq is None else noise_seq.shape[:-2],
        () if init_u is None else init_u.shape[:-1],
        edge_state.phases.shape[:-3] if edge else (),
        () if edge_eps is None else edge_eps.shape[:-4])
    if rows is not None and len(batch) != 1:
        raise ValueError(f"rows needs a 1-D batch, got {batch}")
    # draws are the whole batch's (B_all rows); ``keep``: the rows that run
    B_all = math.prod(batch)
    keep = slice(None) if rows is None else rows
    B = len(range(B_all)[keep])

    def every(t, n, keep=keep):
        """``t`` over the whole batch, rows ``keep``: (B, *its last n dims)."""
        tail = t.shape[t.dim() - n:]
        return t.expand(batch + tail).reshape(B_all, *tail)[keep]

    mag_b, scale_b = every(mag, 0), every(noise_scale, 0)[:, None]
    # ONE turbulence for every scenario: a host-number start step and, on
    # the conditional flow, an unbatched state and border noise
    shared = host_start and (not edge or edge_state.phases.dim() == 3 and (
        edge_eps is None or edge_eps.dim() == 4))
    flow, turbulence = _turbulence(models, layers, R, shared, start, every,
                                   rows, edge_model, edge_state,
                                   turb_generator, edge_eps)
    noise_at = ((lambda idx: estimator_model.sample_noise(
        est, generator, (B_all,))[keep]) if noise_seq is None
        else (lambda idx: every(noise_seq[..., idx, :], 1)))
    estimate = _estimator(models, cfg, scale_b)
    solve = _solver(models, cfg, solver)
    hold = cfg.mpc.cold_start == "hold"
    stack = models.state_stack.reshape(nx, R * R)
    w2 = (2 * est.crop_half + 1) ** 2
    peak_dl = torch.max(est.b_s[w2:2 * w2])
    u0 = torch.zeros((B, nu), dtype=torch.float32, device=dev)
    x_0 = torch.zeros((B, nx), dtype=torch.float32, device=dev)
    first = LoopCarry(u0 if init_u is None else every(init_u, 1).clone(),
                      u0, torch.zeros_like(u0), x_0, torch.zeros_like(x_0),
                      flow)

    def step(carry: LoopCarry, idx: int):
        u1 = carry.u1
        # -- turbulence (README.md:447-453) --
        with profiling.span("turbulence"):
            flow, pt_unit = turbulence(carry, idx)
        # -- correction: the DM phase of the last command --
        with profiling.span("synthesis"):
            ad_cor = u1 @ models.influence.T
            phase_res = (ad_cor @ stack).reshape(B, R, R)
            phase_res.addcmul_(mag_b[:, None, None], pt_unit)
        # -- estimator (README.md:457-480) --
        with profiling.span("measure"):
            noise = scale_b * noise_at(idx)
            y_clean = estimator_model.measure(est, phase_res)
            y = y_clean + noise
        with profiling.span("estimate"):
            x0 = estimate(y, idx, carry)
        with profiling.span("solve"):
            # -- QP assembly (README.md:483-501); "hold": first-step
            # x0_pre = x0 instead of zeros (see MPCConfig.cold_start)
            x_pre_eff = x0 if hold and idx == 0 else carry.x_pre
            bref = mpc.b_ref(models.mats, u1, carry.u2)
            r, c, x_free = mpc.gradient_terms(models.mats, x0, x_pre_eff,
                                              bref)
            U = solve(x0, x_pre_eff, bref, r, u1).reshape(B, -1)
            # -- actuate (README.md:576-601) --
            u = U[:, :nu]
        with profiling.span("telemetry"):
            volts = dm_model.rad_to_volts(u, cfg.dm.coeff_a, cfg.dm.coeff_b,
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
            out = StepOutputs(
                u=u, du=u - u1, volts=volts, x_est=x0,
                x_est_norm=torch.linalg.vector_norm(x0, dim=-1),
                x_pred_norm=torch.linalg.vector_norm(x_pred[:, :nx], dim=-1),
                cost=cost, rms_res=rms_res, rms_turb=rms_turb,
                strehl=torch.exp(-rms_res ** 2), strehl_exact=strehl_exact)
        return LoopCarry(u, u1, carry.u2, x0, carry.x_pre, flow), out

    return first, step, (batch if rows is None else (B,))


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
    ``start_step`` over a batch of scenarios: make_step's step once for
    each step.

    The batch is the broadcast of ``mag`` (default cfg.sim magnification),
    ``noise_scale``, ``start_step`` and the batch dims of ``noise_seq``,
    ``init_u``, ``edge_state`` and ``edge_eps``; all scalars give the
    single-scenario loop, outputs (T, ...).  A host-number ``start_step``
    is ONE turbulence window shared by every scenario, sampled and
    piston-removed once a step and broadcast; a (B,) tensor gives each
    scenario its own window.  Measurement noise is ``noise_scale *
    noise_seq[..., t, :]`` when ``noise_seq`` ((*batch, T, p) or (T, p),
    the parity tests' injected sequence) is given, else drawn per step
    from ``generator`` (on the models' device).  ``init_u`` ((nu,) or
    (*batch, nu)) is the acquisition warm start (MPCConfig.warm_start):
    the DM starts at that command, so step 0 sees only the prediction
    error and its du is u - init_u.

    ``edge_model``/``edge_state`` switch the turbulence to the
    conditional-Gaussian flow (ops/edge_flow.advance; ``layers`` may then
    be None).  An (L, n, n) state with a host-number ``start_step`` is
    ONE realization shared by every scenario, advanced once a step and
    broadcast; a (B, L, n, n) state, per-scenario start steps or
    per-scenario ``edge_eps`` give each scenario its own flow and border
    noise.  The border noise is ``edge_eps`` when given ((T, K_max+1, L,
    nX), or (*batch, T, K_max+1, L, nX); the parity tests' normals), else
    drawn from ``turb_generator`` (default ``generator``).

    ``rows`` (a slice of a 1-D batch) runs only those scenarios, outputs
    (len(rows), T, ...), every random draw still the whole batch's with
    its rows kept: a scenario's trajectory does not depend on which rows
    run beside it (parallel/montecarlo.make_sharded_runner).
    """
    carry, step, batch = make_step(
        models, layers, cfg, generator, n_steps, start_step, solver, mag,
        noise_scale, noise_seq, init_u, edge_model, edge_state,
        turb_generator, edge_eps, rows)
    steps = []
    for idx in range(n_steps):
        with profiling.span("loop.step", step=idx):
            carry, out = step(carry, idx)
        steps.append(out)
    with profiling.span("telemetry"):
        return StepOutputs(*(
            torch.stack(col, dim=1).reshape(*batch, n_steps,
                                            *col[0].shape[1:])
            for col in zip(*steps)))


def turbulence_rollout(layers: phase_screens.FrozenFlowLayers,
                       fit_full: torch.Tensor, mask: torch.Tensor,
                       mask_npix: torch.Tensor, n_steps: int,
                       resolution: int, start_step: int = 0,
                       mag: float = 1.0) -> torch.Tensor:
    """Open-loop pre-pass: frozen-flow evolution -> piston-removed phase ->
    Zernike coefficients (README.md:69-93), zernike.ROLLOUT_CHUNK steps a
    gather.  Returns (n_steps, n_modes) coefficients (piston column
    included)."""
    dev = layers.screens.device
    R = resolution
    out, chunk = [], zernike.ROLLOUT_CHUNK
    for s in range(0, n_steps, chunk):
        steps = torch.arange(s, min(s + chunk, n_steps), device=dev)
        ph = phase_screens.piston_removed_phase_at(
            layers, (steps + start_step).to(torch.float32), R, mask,
            mask_npix) * mag
        out.append(ph.reshape(-1, R * R) @ fit_full.T)
    return torch.cat(out)
