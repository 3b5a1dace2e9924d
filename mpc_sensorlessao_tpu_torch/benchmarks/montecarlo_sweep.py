"""Monte-Carlo closed-loop sweep at scale: D/r0 x SNR x noise seeds (port
of the repository's ``benchmarks/montecarlo_sweep.py``).

Per turbulence strength, one tuned build (radial order 10, ridge VAR,
mmse estimator with prior scale min(0.15, 0.5/d), warm start, r_weight
30; the sim defaults, n_train 1000 / n_valid 500) and a BATCH of noise
realizations across an SNR grid on the shared test window, run as one
batched closed loop from the warm-start command -- 4 x (4 SNR x 64
seeds) x 500 steps by default -- with per-cell settled statistics and
divergence containment (a scenario is kept while its settled residual
is finite and at most 10x the turbulence).

The batch runs once to warm up (the kernels build at first use) and is
timed on its second run, after a device synchronize.  The measurement
noise comes from a torch generator seeded int(d) (the JAX
PRNGKey(int(d)) stream cannot be reproduced); the screens are the JAX
package's.

Usage: python -m mpc_sensorlessao_tpu_torch.benchmarks.montecarlo_sweep
       [resolution] [out.json]
Env:   MC_DR0=5,10,15,20  MC_SNR=5,10,20,40  MC_REPS=64  MC_STEPS=500
       MC_DEVICE=cuda (the card unless "cpu" is named)
The report is printed, and written only to the out.json given.
"""

from __future__ import annotations

import json
import os
import sys
import time

import torch

from ..models import pipeline
from ..parallel import montecarlo
from ..utils.config import SystemConfig
from . import _protocol as P


def sweep_cfg(resolution: int, d: float, n_steps: int) -> SystemConfig:
    """The tuned build of one D/r0 (the sim's 1000/500 split)."""
    return P.tuned_cfg(P.protocol_cfg(resolution, n_steps), d)


def scenarios(cfg: SystemConfig, d: float, snr_grid, reps: int,
              dev) -> montecarlo.ScenarioBatch:
    """len(snr_grid) * reps scenarios on the shared test window (scenario
    i * reps + r: SNR i), noise scale 10^((SNR_cfg - snr)/20), noise
    seed int(d)."""
    scales = [10.0 ** ((cfg.estimator.snr_db - s) / 20.0) for s in snr_grid]
    return P.shared_scenarios(
        cfg, [cfg.sim.magnification] * (len(snr_grid) * reps),
        [s for s in scales for _ in range(reps)], int(d), dev)


def run(system, cfg: SystemConfig, scen: montecarlo.ScenarioBatch,
        init_u: torch.Tensor, dev):
    """The batch's closed loop from the warm start, synchronized."""
    out = montecarlo.run_batch(system.loop, system.layers, cfg, scen,
                               n_steps=cfg.sim.n_test, shared_window=True,
                               init_u=init_u)
    P.sync(dev)
    return out


def sweep_d(resolution: int, d: float, snr_grid, reps: int, n_steps: int,
            dev) -> tuple[dict, float, object]:
    """One D/r0: build, warm start, a warm-up run and the timed run.
    Returns (its cells, the timed run's seconds, its outputs)."""
    cfg = sweep_cfg(resolution, d, n_steps)
    system = pipeline.build(cfg, dev)
    init_u = pipeline.warm_start_command(system, cfg,
                                         cfg.sim.n_train + cfg.sim.n_valid)
    scen = scenarios(cfg, d, snr_grid, reps, dev)
    run(system, cfg, scen, init_u, dev)
    t0 = time.time()
    out = run(system, cfg, scen, init_u, dev)
    dt = time.time() - t0
    return P.mc_cells(out, d, snr_grid, reps), dt, out


def main(argv=None, env=None) -> dict:
    """Run the sweep; returns the report, prints it, and writes it to the
    out.json argument when one is given."""
    argv = sys.argv[1:] if argv is None else list(argv)
    env = os.environ if env is None else env
    res = int(argv[0]) if argv else 128
    out_path = argv[1] if len(argv) > 1 else None
    dev = P.device(env, "MC_DEVICE")
    d_grid = [float(x) for x in env.get("MC_DR0", "5,10,15,20").split(",")]
    snr_grid = [float(x) for x in env.get("MC_SNR", "5,10,20,40").split(",")]
    reps = int(env.get("MC_REPS", "64"))
    n_steps = int(env.get("MC_STEPS", "500"))

    report = {"resolution": res, "n_steps": n_steps, "reps": reps,
              "device": P.device_name(dev), "cells": {}}
    total_steps = 0
    total_time = 0.0
    for d in d_grid:
        cells, dt, _ = sweep_d(res, d, snr_grid, reps, n_steps, dev)
        n = len(snr_grid) * reps
        total_steps += n * n_steps
        total_time += dt
        report["cells"].update(cells)
        print(f"d={d:g}: {n} scenarios x {n_steps} steps in {dt:.2f}s "
              f"({n * n_steps / dt:,.0f} steps/s)", file=sys.stderr)

    report["total_control_steps"] = total_steps
    report["total_loop_s"] = round(total_time, 2)
    report["steps_per_s"] = round(total_steps / total_time, 1)
    P.save_report(report, out_path)
    print(json.dumps(report, indent=2))
    return report


if __name__ == "__main__":
    main()
