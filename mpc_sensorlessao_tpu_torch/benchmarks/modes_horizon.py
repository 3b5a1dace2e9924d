"""BASELINE config 3: mode sweep 28 -> 66 -> 120 (radial order 6/10/14)
with longer MPC horizons, closed loop (port of the repository's
``benchmarks/modes_horizon.py``).

The reference fixes 28 modes and N=2 (README.md:38,338).  This sweep
closes the loop at every (radial order, horizon) cell of {6,10,14} x
{2,8,32} and records settled Strehl, rejection and solves/s.  The N=32
cells also run with newton_steps=2, which takes the general Newton-KKT
solve, whose Schur solve is block cyclic reduction from
newton_kkt.CR_MIN_HORIZON on.

One build per order (the expensive layers do not depend on the
horizon); horizons swap in through pipeline.with_horizon.  The recipe
is the tuned one at D/r0=5 (ridge VAR, mmse prior scale 0.1, warm start,
r_weight 30) with the VAR companion-radius clamp 0.85: the order-14
LS/ridge fit sits at spectral radius ~0.996, and the N >= 8 free
responses amplify its noisy high-order rows into a collapse.  Each cell
runs B scenarios on the shared test window from the warm start, noise
seed 1; it runs once to warm up and is timed on its second run, after a
device synchronize.

Usage: python -m mpc_sensorlessao_tpu_torch.benchmarks.modes_horizon
       [out.json]
Env:   MODES_RES=128  MODES_BATCH=64  MODES_STEPS=200
       MODES_ORDERS=6,10,14  MODES_HORIZONS=2,8,32
       MODES_TRAIN=1000 (n_valid=500 at the default; else n_valid=50)
       MODES_DEVICE=cuda (the card unless "cpu" is named)
The report is printed, and written only to the out.json given.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import time

from ..models import pipeline
from ..ops import newton_kkt
from ..parallel import montecarlo
from ..utils.config import SystemConfig
from . import _protocol as P

D_OVER_R0 = 5.0
VAR_MAX_RADIUS = 0.85


def base_cfg(resolution: int, n_steps: int, n_train: int = 1000) -> \
        SystemConfig:
    """reference_config(resolution) with n_steps steps; a train split other
    than the default 1000 takes n_valid 50."""
    return P.protocol_cfg(resolution, n_steps,
                          n_train=None if n_train == 1000 else n_train)


def order_cfg(base: SystemConfig, order: int) -> SystemConfig:
    """The build of one radial order: the tuned recipe at D/r0=5 (whose
    mmse prior scale min(0.15, 0.5/5) is the sweep's 0.1) with the VAR
    clamp."""
    return P.tuned_cfg(base, D_OVER_R0, radial_order=order,
                       var_max_radius=VAR_MAX_RADIUS)


def variants(horizon: int) -> list[tuple[str, int]]:
    """(tag, newton_steps) of the cells at one horizon: the fixed step,
    and from CR_MIN_HORIZON on the general solve (cyclic reduction)."""
    return [("fixed", 1)] + ([("general_cr", 2)]
                             if horizon >= newton_kkt.CR_MIN_HORIZON else [])


def cell_cfg(cfg_o: SystemConfig, horizon: int,
             newton_steps: int) -> SystemConfig:
    return cfg_o.replace(mpc=dataclasses.replace(
        cfg_o.mpc, horizon=horizon, newton_steps=newton_steps))


def run_cell(system, cfg: SystemConfig, batch: int, dev):
    """One cell: ``batch`` scenarios on the shared test window from the
    warm start of ``system`` (already at cfg's horizon), noise seed 1;
    a warm-up run, then the timed run.  Returns (row, outputs)."""
    start = cfg.sim.n_train + cfg.sim.n_valid
    init_u = pipeline.warm_start_command(system, cfg, start)
    scen = P.shared_scenarios(cfg, [cfg.sim.magnification] * batch,
                              [1.0] * batch, 1, dev)
    n_steps = cfg.sim.n_test

    def once():
        out = montecarlo.run_batch(system.loop, system.layers, cfg, scen,
                                   n_steps, shared_window=True,
                                   init_u=init_u)
        P.sync(dev)
        return out
    once()
    t0 = time.time()
    out = once()
    t_loop = time.time() - t0
    return P.modes_row(out, t_loop, batch, n_steps), out


def sweep_order(base: SystemConfig, order: int, horizons, batch: int,
                dev) -> dict:
    """Every cell of one radial order, from one build."""
    cfg_o = order_cfg(base, order)
    t0 = time.time()
    system = pipeline.build(cfg_o, dev)
    P.sync(dev)
    build_s = time.time() - t0
    n_modes = (order + 1) * (order + 2) // 2
    print(f"order {order} ({n_modes} modes) built in {build_s:.1f}s",
          file=sys.stderr, flush=True)
    cells = {}
    for N in horizons:
        for tag, newton_steps in variants(N):
            cfg = cell_cfg(cfg_o, N, newton_steps)
            row, _ = run_cell(pipeline.with_horizon(system, cfg), cfg, batch,
                              dev)
            row["build_s"] = round(build_s, 1)
            key = f"order={order}_N={N}_{tag}"
            cells[key] = row
            print(json.dumps({key: row}), file=sys.stderr, flush=True)
    return cells


def main(argv=None, env=None) -> dict:
    """Run the sweep; returns the report, prints it, and writes it to the
    out.json argument when one is given."""
    argv = sys.argv[1:] if argv is None else list(argv)
    env = os.environ if env is None else env
    out_path = argv[0] if argv else None
    dev = P.device(env, "MODES_DEVICE")
    res = int(env.get("MODES_RES", "128"))
    batch = int(env.get("MODES_BATCH", "64"))
    n_steps = int(env.get("MODES_STEPS", "200"))
    orders = [int(o) for o in env.get("MODES_ORDERS", "6,10,14").split(",")]
    horizons = [int(h) for h in
                env.get("MODES_HORIZONS", "2,8,32").split(",")]
    base = base_cfg(res, n_steps, int(env.get("MODES_TRAIN", "1000")))

    report = {
        "what": ("BASELINE config 3 sweep: radial order x MPC horizon, "
                 "closed loop on chip; N=32 cells additionally run via "
                 "the general Newton-KKT path (newton_steps=2) with "
                 "cyclic reduction engaged (CR_MIN_HORIZON=16)"),
        "resolution": res, "batch": batch, "n_steps": n_steps,
        "n_train": base.sim.n_train, "n_valid": base.sim.n_valid,
        "d_over_r0": 5, "device": P.device_name(dev),
        "cells": {},
    }
    for order in orders:
        report["cells"].update(sweep_order(base, order, horizons, batch, dev))
    P.save_report(report, out_path)
    print(json.dumps(report, indent=2))
    return report


if __name__ == "__main__":
    main()
