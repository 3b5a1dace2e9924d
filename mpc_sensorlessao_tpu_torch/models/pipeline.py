"""End-to-end pipeline: turbulence -> system ID -> closed-loop MPC (port of
``mpc_sensorlessao_tpu/models/pipeline.py``).

  L1 frozen-flow screens -> L2 Zernike series -> L3 VAR fit
  -> L4 DM influence -> L5 estimator model -> L6 MPC matrices
  -> L7 closed-loop simulation,
with every tensor on one explicit device.  Screens, basis, DM and the
estimator's solve operator are built in host numpy float64; the VAR fit,
the MPC matrices and the fixed Newton operator in float64 torch; all are
rounded once to float32 for the loop.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from ..ops import phase_screens, zernike
from ..utils import tree
from ..utils.config import SystemConfig
from . import closed_loop, dm, estimator, mpc, solvers, var


@dataclass(frozen=True)
class System:
    """All precomputed models for a configured scenario."""

    basis: zernike.ZernikeBasis
    layers: phase_screens.FrozenFlowLayers
    est: estimator.EstimatorModel
    dm_model: dm.DMModel
    var_model: var.VARModel
    mats: mpc.MPCMatrices
    loop: closed_loop.LoopModels
    coeff_series: torch.Tensor    # (n_id, n_modes) open-loop Zernike series


def build(cfg: SystemConfig, device: torch.device | str = "cuda") -> System:
    """Build every subsystem from a config; screens are seeded from
    cfg.sim.seed."""
    if cfg.atmosphere.flow == "conditional":
        raise NotImplementedError(
            "atmosphere.flow='conditional' is not ported yet (ROADMAP.md A.9)")
    if cfg.atmosphere.flow != "periodic":
        raise ValueError(f"unknown atmosphere.flow '{cfg.atmosphere.flow}'")
    if cfg.mpc.var_ridge < 0.0:
        raise ValueError(f"var_ridge must be >= 0, got {cfg.mpc.var_ridge}")
    R = cfg.resolution
    tel = dataclasses.replace(cfg.telescope, resolution=R)

    basis = zernike.make_basis(cfg.zernike.radial_order, R, device=device)
    layers = phase_screens.make_layers(int(cfg.sim.seed), cfg.atmosphere,
                                       tel, device=device)
    est = estimator.build(cfg.estimator, basis, device=device)
    dm_model = dm.build(cfg.dm, basis, device=device)

    # open-loop pre-pass over train+valid (the closed loop runs on the
    # test window, README.md:112-115,429-430), magnified as
    # README.md:283-284
    mask_npix = torch.tensor(float(basis.mask.sum()), dtype=torch.float32,
                             device=device)
    coeffs = closed_loop.turbulence_rollout(
        layers, basis.fit_full, basis.mask, mask_npix,
        n_steps=cfg.sim.n_train + cfg.sim.n_valid, resolution=R,
        mag=cfg.sim.magnification)

    # VAR fit on the training window, piston removed (README.md:110-130)
    vmodel = var.fit(coeffs[:cfg.sim.n_train, 1:].double(),
                     cfg.mpc.var_order, ridge=cfg.mpc.var_ridge)
    if cfg.mpc.var_max_radius is not None:
        vmodel = var.stabilize(vmodel, cfg.mpc.var_max_radius)
    A1 = vmodel.coefficient(1)
    A2 = (vmodel.coefficient(2) if cfg.mpc.var_order >= 2
          else torch.zeros_like(A1))

    influence = dm_model.influence.double()
    nx, nu = influence.shape
    eye = dict(dtype=torch.float64, device=device)
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
    return System(basis=basis, layers=layers, est=est, dm_model=dm_model,
                  var_model=tree.cast(vmodel, torch.float32), mats=mats,
                  loop=loop, coeff_series=coeffs)


def run_closed_loop(system: System, cfg: SystemConfig,
                    generator: torch.Generator, n_steps: int | None = None,
                    solver: str | None = None) -> closed_loop.StepOutputs:
    """Closed loop over the test window (after train+valid)."""
    if cfg.mpc.warm_start:
        raise NotImplementedError(
            "mpc.warm_start is not ported yet (ROADMAP.md A.7)")
    return closed_loop.simulate(
        system.loop, system.layers, cfg, generator,
        n_steps=cfg.sim.n_test if n_steps is None else n_steps,
        start_step=cfg.sim.n_train + cfg.sim.n_valid, solver=solver)
