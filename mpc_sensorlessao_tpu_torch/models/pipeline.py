"""End-to-end pipeline: turbulence -> system ID -> closed-loop MPC (port of
``mpc_sensorlessao_tpu/models/pipeline.py``).

  L1 frozen-flow screens (periodic, or the conditional-Gaussian flow)
  -> L2 Zernike series -> L3 VAR fit
  -> L4 DM influence -> L5 estimator model -> L6 MPC matrices
  -> L7 closed-loop simulation,
with every tensor on one explicit device.  Screens, basis, DM and the
estimator's solve operator are built in host numpy float64; the VAR fit,
the MPC matrices and the fixed Newton operator in float64 torch; all but
the VAR model are rounded once to float32 for the loop.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from ..ops import edge_flow, phase_screens, zernike, zernike_stats
from ..utils import profiling, tree
from ..utils.config import SystemConfig
from . import closed_loop, dm, estimator, mpc, solvers, var


@dataclass(frozen=True)
class System:
    """All precomputed models for a configured scenario."""

    basis: zernike.ZernikeBasis
    layers: phase_screens.FrozenFlowLayers | None   # None: conditional flow
    est: estimator.EstimatorModel
    dm_model: dm.DMModel
    var_model: var.VARModel       # float64: the controller is built from it
    mats: mpc.MPCMatrices
    loop: closed_loop.LoopModels
    coeff_series: torch.Tensor    # (n_id, n_modes) open-loop Zernike series
    # the conditional flow (atmosphere.flow="conditional"): its model, and
    # its state at the test split (after the n_train + n_valid rollout)
    edge_model: edge_flow.EdgeFlowModel | None = None
    edge_state: edge_flow.EdgeFlowState | None = None


def _controller(cfg: SystemConfig, vmodel: var.VARModel,
                basis: zernike.ZernikeBasis, est: estimator.EstimatorModel,
                dm_model: dm.DMModel):
    """The horizon-dependent controller from a float64 VAR model: the
    condensed MPC design matrices, the fastMPC problem and the fixed
    Newton operator (in make_loop_models), built in float64 and rounded
    once to float32.  The single definition of the Q/P/R weighting,
    shared by build() and with_horizon() so that a horizon sweep runs
    exactly the controller build() gives."""
    A1 = vmodel.coefficient(1)
    A2 = (vmodel.coefficient(2) if cfg.mpc.var_order >= 2
          else torch.zeros_like(A1))
    influence = dm_model.influence.to(A1)
    nx, nu = influence.shape
    eye = dict(dtype=torch.float64, device=A1.device)
    mats = mpc.design_matrices(
        A1, A2, influence, cfg.mpc.horizon,
        cfg.mpc.q_weight * torch.eye(nx, **eye),
        cfg.mpc.p_weight_scale * cfg.mpc.q_weight * torch.eye(nx, **eye),
        cfg.mpc.r_weight * torch.eye(nu, **eye))
    prob = solvers.make_fastmpc_problem(
        A1, A2, influence, q_weight=cfg.mpc.q_weight,
        p_weight=cfg.mpc.p_weight_scale * cfg.mpc.q_weight,
        r_weight=cfg.mpc.r_weight, u_max=cfg.mpc.u_max,
        barrier_k=cfg.mpc.barrier_k, du_max=cfg.mpc.du_max)
    mats = tree.cast(mats, torch.float32)
    loop = closed_loop.make_loop_models(
        basis, est, dm_model, mats, tree.cast(prob, torch.float32),
        horizon=cfg.mpc.horizon)
    return mats, loop


def build(cfg: SystemConfig, device: torch.device | str = "cuda") -> System:
    """Build every subsystem from a config; screens, and the
    conditional flow's border draws, are seeded from cfg.sim.seed."""
    flow = cfg.atmosphere.flow
    if flow not in ("periodic", "conditional"):
        raise ValueError(f"unknown atmosphere.flow '{flow}'")
    if cfg.mpc.var_ridge < 0.0:
        raise ValueError(f"var_ridge must be >= 0, got {cfg.mpc.var_ridge}")
    R = cfg.resolution
    tel = dataclasses.replace(cfg.telescope, resolution=R)

    with profiling.span("setup.operators"):
        basis = zernike.make_basis(cfg.zernike.radial_order, R,
                                   device=device)
        prior_cov = None
        if cfg.estimator.method == "mmse":
            # analytic Von Karman Zernike-coefficient covariance as the
            # residual-aberration prior (piston excluded; the
            # magnification scales coefficients linearly, so the
            # covariance by mag^2)
            C = zernike_stats.covariance_analytic(
                cfg.atmosphere, cfg.telescope.diameter,
                cfg.zernike.radial_order)
            prior_cov = (C[1:, 1:] * cfg.sim.magnification ** 2
                         * cfg.estimator.prior_scale ** 2)
        est = estimator.build(cfg.estimator, basis, prior_cov=prior_cov,
                              device=device)
        dm_model = dm.build(cfg.dm, basis, device=device)
        mask_npix = torch.tensor(float(basis.mask.sum()),
                                 dtype=torch.float32, device=device)

    # open-loop pre-pass over train+valid (the closed loop runs on the
    # test window, README.md:112-115,429-430), magnified as
    # README.md:283-284
    n_id = cfg.sim.n_train + cfg.sim.n_valid
    layers = edge_model = edge_state = None
    with profiling.span("setup.screens"):
        if flow == "conditional":
            edge_model, state0 = edge_flow.build(
                int(cfg.sim.seed), cfg.atmosphere, tel,
                op_dtype=cfg.atmosphere.edge_op_dtype, device=device)
        else:
            layers = phase_screens.make_layers(
                int(cfg.sim.seed), cfg.atmosphere, tel, device=device)
    with profiling.span("setup.rollout"):
        if flow == "conditional":
            gen = torch.Generator(device=device)
            gen.manual_seed(int(cfg.sim.seed))
            edge_state, coeffs = edge_flow.rollout(
                edge_model, state0, gen, n_id, basis.fit_full, basis.mask,
                mask_npix, mag=cfg.sim.magnification)
        else:
            coeffs = closed_loop.turbulence_rollout(
                layers, basis.fit_full, basis.mask, mask_npix, n_steps=n_id,
                resolution=R, mag=cfg.sim.magnification)

    with profiling.span("setup.operators"):
        # VAR fit on the training window, piston removed
        # (README.md:110-130)
        vmodel = var.fit(coeffs[:cfg.sim.n_train, 1:].double(),
                         cfg.mpc.var_order, ridge=cfg.mpc.var_ridge)
        if cfg.mpc.var_max_radius is not None:
            vmodel = var.stabilize(vmodel, cfg.mpc.var_max_radius)
        mats, loop = _controller(cfg, vmodel, basis, est, dm_model)
    return System(basis=basis, layers=layers, est=est, dm_model=dm_model,
                  var_model=vmodel, mats=mats, loop=loop,
                  coeff_series=coeffs, edge_model=edge_model,
                  edge_state=edge_state)


def with_horizon(system: System, cfg: SystemConfig) -> System:
    """Rebuild only the horizon-dependent MPC operators on a built System.

    The screens, basis, estimator and VAR fit do not depend on the
    horizon; a horizon sweep (BASELINE config 3: "longer MPC horizons")
    needs new design matrices and a new fixed Newton operator, built from
    the system's float64 VAR model as build() builds them.
    """
    mats, loop = _controller(cfg, system.var_model, system.basis,
                             system.est, system.dm_model)
    return dataclasses.replace(system, mats=mats, loop=loop)


def run_closed_loop(system: System, cfg: SystemConfig,
                    generator: torch.Generator, n_steps: int | None = None,
                    solver: str | None = None) -> closed_loop.StepOutputs:
    """Closed loop over the test window (after train+valid), from the
    warm-start command when cfg.mpc.warm_start is set; on the
    conditional flow from the system's edge_state, its border noise drawn
    from ``generator`` too."""
    start = cfg.sim.n_train + cfg.sim.n_valid
    init_u = (warm_start_command(system, cfg, start) if cfg.mpc.warm_start
              else None)
    return closed_loop.simulate(
        system.loop, system.layers, cfg, generator,
        n_steps=cfg.sim.n_test if n_steps is None else n_steps,
        start_step=start, solver=solver, init_u=init_u,
        edge_model=system.edge_model, edge_state=system.edge_state)


def warm_start_command(system: System, cfg: SystemConfig,
                       start: int) -> torch.Tensor:
    """Calibration-handover DM command (MPCConfig.warm_start), float32 on
    the system's device.

    Predicts the state at the first closed-loop step from the last two
    identification states (known with direct phase access during ID,
    README.md:86-93) through the fitted VAR model, and fits the DM to
    cancel it: u0 = argmin ||B u + x_pred||^2 + lam ||u||^2, with the
    ridge lam raised tenfold (up to 20 times) until max|u0| <= 0.5 u_max:
    a plain pseudo-inverse at high mode counts asks for commands far
    past the box, and clipping those injects garbage.  Host float64.
    """
    def f64(t):
        return t.detach().cpu().double().numpy()

    with profiling.span("setup.operators"):
        states = f64(system.coeff_series[:, 1:])
        x_pred = f64(system.var_model.coefficient(1)) @ states[start - 1]
        if cfg.mpc.var_order >= 2:
            x_pred = x_pred + f64(system.var_model.coefficient(2)) @ states[
                start - 2]
        B = f64(system.dm_model.influence)
        gram = B.T @ B
        lam = 1e-6 * np.trace(gram) / gram.shape[0]
        for _ in range(20):
            u0 = np.linalg.solve(gram + lam * np.eye(gram.shape[0]),
                                 -B.T @ x_pred)
            if np.abs(u0).max() <= 0.5 * cfg.mpc.u_max:
                break
            lam *= 10.0
        return torch.as_tensor(u0, dtype=torch.float32,
                               device=system.dm_model.influence.device)
