"""Flagship-scale reference protocol sweep, D/r0 in {5, 10, 15, 20} (port
of the repository's ``benchmarks/protocol_sweep.py``).

The reference's full experimental protocol at its real scale
(README.md:36-37,112-115,277-284): 512-px pupil grid, 2000 frames at
200 Hz (1000 train / 500 valid / 500 test), VAR(2) identification with
held-out validation, then the 500-step closed-loop MPC run at every
published turbulence strength (the reference's mag_conv multipliers
for D/r0 = 5, 10, 15, 20).

Two row families per D/r0:
  reference: the reference's operating point -- 28 Zernike modes, plain
             LS estimator/ID, cold start: ONE build, the magnification
             swept as a scenario axis over one shared turbulence window
             (the LS VAR fit is scale-invariant);
  tuned:     the recipe that extends the closed-loop envelope (radial
             order 10, ridge VAR, mmse estimator with prior scale
             min(0.15, 0.5/d), warm start, r_weight 30): one build per
             D/r0, because the prior and the warm start depend on it,
             run through pipeline.run_closed_loop.

The screens come from the same integer seeds as the JAX package's, so
the turbulence is the same; the measurement noise is drawn from torch
generators seeded 1 (the JAX PRNGKey(1) stream cannot be reproduced).

Usage: python -m mpc_sensorlessao_tpu_torch.benchmarks.protocol_sweep
       [resolution] [out.json]
Env:   PROTO_DR0=5,10    the D/r0 grid
       PROTO_STEPS=50    closed-loop steps (default n_test=500)
       PROTO_TRAIN=300   ID train split, with n_valid=50 (default 1000/500)
       PROTO_STAGES=ref,tuned  the stages to run; with out.json given and
                         holding a report of the same device,
                         resolution, split and steps, the run merges
                         into its rows (SECTIONS); another is not merged
       PROTO_TUNED_DR0   the tuned rows' grid (default PROTO_DR0)
       PROTO_SKIP_TUNED=1  reference rows only
       PROTO_DEVICE=cuda the card unless "cpu" is named
The report is printed, and written only to the out.json given.
"""

from __future__ import annotations

import json
import os
import sys
import time

from ..models import pipeline
from ..parallel import montecarlo
from ..utils.config import SystemConfig, mag_conv
from . import _protocol as P

# the report's row sections, which a staged run merges (the rest is the
# fresh run's metadata)
SECTIONS = ("reference_build_s", "reference_var", "reference_loop_s",
            "reference_solves_per_s", "reference_rows", "tuned_rows")


def base_cfg(resolution: int, env) -> SystemConfig:
    """reference_config(resolution) with PROTO_TRAIN's split (n_valid 50)
    and PROTO_STEPS closed-loop steps."""
    return P.protocol_cfg(resolution, P.env_int(env, "PROTO_STEPS"),
                          n_train=P.env_int(env, "PROTO_TRAIN"))


def reference_scenarios(cfg: SystemConfig, d_grid, dev) -> \
        montecarlo.ScenarioBatch:
    """One scenario per D/r0 of the grid on the shared test window, its
    magnification mag_conv(d), noise seed 1."""
    return P.shared_scenarios(cfg, [mag_conv(d) for d in d_grid],
                              [1.0] * len(d_grid), 1, dev)


def reference_rows(cfg: SystemConfig, d_grid, dev) -> tuple[dict, object,
                                                            object]:
    """The reference stage: one build, the D/r0 grid as a scenario axis
    over one shared window.  Returns (the report's reference entries,
    the system, the run's outputs)."""
    t0 = time.time()
    system = pipeline.build(cfg, dev)
    P.sync(dev)
    part = {"reference_build_s": round(time.time() - t0, 1),
            "reference_var": P.var_validation(cfg, system)}
    n_steps = cfg.sim.n_test
    t0 = time.time()
    out = montecarlo.run_batch(system.loop, system.layers, cfg,
                               reference_scenarios(cfg, d_grid, dev),
                               n_steps=n_steps, shared_window=True)
    P.sync(dev)
    t_loop = time.time() - t0
    part["reference_loop_s"] = round(t_loop, 2)
    part["reference_solves_per_s"] = round(len(d_grid) * n_steps / t_loop, 1)
    part["reference_rows"] = {f"d_over_r0={d:g}": P.settled_row(out, i)
                              for i, d in enumerate(d_grid)}
    return part, system, out


def tuned_build(cfg: SystemConfig, d: float, dev, radial_order: int = 10,
                var_max_radius: float | None = None):
    """The tuned build at D/r0 = d (P.tuned_cfg).  Returns (its config,
    the system, the build's seconds)."""
    cfg_t = P.tuned_cfg(cfg, d, radial_order, var_max_radius)
    t0 = time.time()
    system = pipeline.build(cfg_t, dev)
    P.sync(dev)
    return cfg_t, system, time.time() - t0


def run_tuned(cfg_t: SystemConfig, system, dev):
    """run_closed_loop from the warm start, its noise from a generator on
    the device seeded 1.  Returns (outputs, seconds)."""
    t0 = time.time()
    out = pipeline.run_closed_loop(system, cfg_t, P.generator(dev, 1))
    P.sync(dev)
    return out, time.time() - t0


def tuned_row(cfg_t: SystemConfig, system, build_s: float, dev):
    """One tuned row (run_tuned).  Returns (row, outputs)."""
    out, loop_s = run_tuned(cfg_t, system, dev)
    row = P.settled_row(out)
    row.update(P.var_validation(cfg_t, system))
    row["build_s"] = round(build_s, 1)
    row["loop_s"] = round(loop_s, 2)
    return row, out


def main(argv=None, env=None) -> dict:
    """Run the stages; returns the report, prints it, and writes it to
    the out.json argument when one is given."""
    argv = sys.argv[1:] if argv is None else list(argv)
    env = os.environ if env is None else env
    res = int(argv[0]) if argv else 512
    out_path = argv[1] if len(argv) > 1 else None
    dev = P.device(env, "PROTO_DEVICE")
    d_grid = [float(d) for d in env.get("PROTO_DR0", "5,10,15,20").split(",")]
    cfg = base_cfg(res, env)
    n_steps = cfg.sim.n_test
    stages = set(env.get("PROTO_STAGES", "ref,tuned").split(","))
    tuned_grid = [float(d) for d in env.get(
        "PROTO_TUNED_DR0", env.get("PROTO_DR0", "5,10,15,20")).split(",")]

    report = {
        "protocol": "README.md:36-37,112-115,277-284 at flagship scale",
        "resolution": res,
        "n_train": cfg.sim.n_train, "n_valid": cfg.sim.n_valid,
        "n_steps": n_steps,
        "device": P.device_name(dev),
        "reference_rows": {}, "tuned_rows": {},
    }
    P.load_report(out_path, report, SECTIONS,
                  knobs=("resolution", "n_train", "n_valid", "n_steps"))

    if "ref" in stages:
        part, _, _ = reference_rows(cfg, d_grid, dev)
        report.update(part)
        print(json.dumps({k: v for k, v in report.items()
                          if k != "tuned_rows"}, indent=2), file=sys.stderr)
        P.save_report(report, out_path)

    if "tuned" in stages and not env.get("PROTO_SKIP_TUNED"):
        for d in tuned_grid:
            cfg_t, system, build_s = tuned_build(cfg, d, dev)
            row, _ = tuned_row(cfg_t, system, build_s, dev)
            del system
            report["tuned_rows"][f"d_over_r0={d:g}"] = row
            print(json.dumps({f"tuned d={d:g}": row}), file=sys.stderr)
            P.save_report(report, out_path)

    P.save_report(report, out_path)
    print(json.dumps(report, indent=2))
    return report


if __name__ == "__main__":
    main()
