"""Multi-rank dry run of every parallel axis (the port's counterpart of
``dryrun_multichip`` in the repository's ``__graft_entry__.py``).

``dryrun_multichip(world)`` spawns ``world`` ranks (multihost.spawn) and
each runs ``dryrun_rank`` on tiny shapes:

1. DP -- the scenario-sharded closed loop (montecarlo.run_sharded) over
   the periodic frozen flow, over the conditional-Gaussian flow with
   one realization shared by the global batch, through the ramp solver
   (fastmpc_ramp) and through the general Newton solve at horizon 16
   (block cyclic reduction);
2. TP -- the pixel-sharded estimate (estimator_tp.sharded_estimate)
   against the unsharded product;
3. SP -- the horizon-sharded block-tridiagonal solve
   (horizon.solve_distributed) against the assembled dense system.

Each check raises on failure; the ranks return their numbers.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from ..models import pipeline
from ..ops import newton_kkt
from ..utils.config import reference_config
from . import estimator_tp, horizon, mesh as mesh_lib, montecarlo, multihost


def small_cfg(resolution=32, crop_half=7, n_act=8, order=4, n_train=150,
              n_valid=20, n_test=30):
    cfg = reference_config(resolution=resolution)
    return cfg.replace(
        sim=dataclasses.replace(cfg.sim, n_train=n_train, n_valid=n_valid,
                                n_test=n_test),
        estimator=dataclasses.replace(cfg.estimator, resolution=resolution,
                                      crop_half=crop_half),
        dm=dataclasses.replace(cfg.dm, n_act_side=n_act),
        zernike=dataclasses.replace(cfg.zernike, radial_order=order),
    )


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(f"dryrun_multichip: {what}")


def dryrun_rank(rank: int, world: int, device: torch.device) -> dict:
    """One rank's part of the dry run (inside an initialized world)."""
    cfg = small_cfg()
    system = pipeline.build(cfg, device)
    out = {}

    # 1. data parallel: the full closed-loop step, scenario-sharded
    mesh = mesh_lib.scenario_mesh(device_type=device.type)
    scen = montecarlo.make_scenarios(
        cfg, torch.Generator().manual_seed(1), 2 * world,
        d_over_r0_grid=(2.0, 5.0, 10.0), snr_db_grid=(5.0, 10.0, 20.0),
        device=device)
    stats = montecarlo.run_sharded(system.loop, system.layers, cfg, scen,
                                   n_steps=2, mesh=mesh)
    _check(float(stats.n_scenarios) == 2 * world, "DP scenario count")
    _check(bool(torch.isfinite(stats.mean_rms_res)), "DP residual")
    _check(bool(torch.isfinite(stats.mean_strehl)), "DP Strehl")
    out["dp"] = stats.as_floats()

    # 1b. DP over the conditional-Gaussian flow, one realization shared
    # by the global batch
    cfg_e = cfg.replace(atmosphere=dataclasses.replace(
        cfg.atmosphere, flow="conditional"))
    sys_e = pipeline.build(cfg_e, device)
    stats_e = montecarlo.make_sharded_runner(
        sys_e.loop, sys_e.layers, cfg_e, 2, mesh,
        edge_model=sys_e.edge_model, edge_state=sys_e.edge_state,
        shared_turbulence=True)(scen)
    _check(float(stats_e.n_scenarios) == 2 * world, "DP (conditional) count")
    _check(bool(torch.isfinite(stats_e.mean_rms_res)),
           "DP (conditional) residual")
    out["dp_conditional"] = stats_e.as_floats()

    # 1c. DP through the ramp solver and through the general Newton solve
    # at horizon 16, whose Schur solve is block cyclic reduction
    cfg_cr = cfg.replace(mpc=dataclasses.replace(
        cfg.mpc, horizon=newton_kkt.CR_MIN_HORIZON, newton_steps=2))
    sys_cr = pipeline.with_horizon(system, cfg_cr)
    for name, (sys_, cfg_, solver) in {
            "dp_ramp": (system, cfg, "fastmpc_ramp"),
            "dp_cyclic_reduction": (sys_cr, cfg_cr, None)}.items():
        st = montecarlo.run_sharded(sys_.loop, sys_.layers, cfg_, scen,
                                    n_steps=2, mesh=mesh, solver=solver)
        _check(float(st.n_scenarios) == 2 * world, f"{name} count")
        _check(bool(torch.isfinite(st.mean_rms_res)), f"{name} residual")
        out[name] = st.as_floats()

    # 2. tensor parallel: the pixel-sharded estimator contraction
    est = system.loop.est
    y = est.b_s + 0.01 * torch.arange(est.n_pixels, dtype=torch.float32,
                                      device=device)
    x_tp = estimator_tp.sharded_estimate(
        est.solve_op, est.b_s, y, estimator_tp.tp_mesh(
            device_type=device.type))
    x_ref = (y - est.b_s) @ est.solve_op.T
    out["tp_max_abs_err"] = float((x_tp - x_ref).abs().max())
    _check(out["tp_max_abs_err"] <= 1e-4, "TP estimate mismatch")

    # 3. horizon parallel: the distributed block-tridiagonal solve
    rng = np.random.default_rng(0)
    n, J = 5, 4 * world
    sub = rng.normal(size=(J, n, n)) * 0.1
    G = rng.normal(size=(J, n, 3 * n))
    diag = np.einsum("jab,jcb->jac", G, G) + 10.0 * np.eye(n)
    rhs = rng.normal(size=(J, n))

    def dev32(a):
        return torch.as_tensor(a, dtype=torch.float32, device=device)
    hz = horizon.hz_mesh(device_type=device.type)
    x_loc = horizon.solve_distributed(dev32(diag), dev32(sub), dev32(rhs),
                                      hz)
    parts = [torch.empty_like(x_loc) for _ in range(world)]
    dist.all_gather(parts, x_loc, group=hz.get_group())
    x = torch.cat(parts).double().cpu().numpy().reshape(-1)
    # residual against the assembled dense system (float32 inputs)
    d32, s32 = (np.asarray(a, np.float32).astype(np.float64)
                for a in (diag, sub))
    A = np.zeros((J * n, J * n))
    for j in range(J):
        A[j * n:(j + 1) * n, j * n:(j + 1) * n] = d32[j]
        if j > 0:
            A[j * n:(j + 1) * n, (j - 1) * n:j * n] = s32[j]
            A[(j - 1) * n:j * n, j * n:(j + 1) * n] = s32[j].T
    res = A @ x - np.asarray(rhs, np.float32).astype(np.float64).reshape(-1)
    out["hz_max_residual"] = float(np.abs(res).max())
    _check(out["hz_max_residual"] < 1e-3, "horizon solve residual")
    return out


def dryrun_multichip(world: int, device: torch.device | str = "cuda",
                     backend: str | None = None) -> list:
    """Spawn ``world`` ranks on ``device`` ("cuda": a card each) and run
    ``dryrun_rank`` in each; returns every rank's numbers."""
    return multihost.spawn(dryrun_rank, world, backend=backend,
                           device=device)
