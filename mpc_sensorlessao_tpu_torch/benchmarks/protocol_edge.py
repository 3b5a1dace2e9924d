"""Flagship protocol on the reference-parity conditional-Gaussian flow
(port of the repository's ``benchmarks/protocol_edge.py``).

The protocol rows of protocol_sweep (README.md:36-37,112-115,277-284) with
``atmosphere.flow="conditional"`` (ops/edge_flow.py), in stages:

  ref       one 28-mode LS build; the D/r0 grid as a scenario axis
            SHARING one turbulence realization (shared_turbulence=True:
            the reference scaling one frozen-flow tensor by each
            mag_conv multiplier), from the build's state;
  mc        a batched Monte-Carlo over noise seeds on that one shared
            realization (make_scenarios, D/r0=5);
  periodic  the same protocol on the periodic flow (protocol_sweep's
            reference rows), for a same-run quality delta;
  tuned     per-D/r0 tuned builds (order 10, ridge VAR, mmse, warm
            start) on the conditional flow, one scenario each through
            pipeline.run_closed_loop.

The border draws and the measurement noise come from torch generators
(the JAX package draws them with jax.random), so the realization of the
flow differs from the JAX one.

Usage: python -m mpc_sensorlessao_tpu_torch.benchmarks.protocol_edge
       [resolution] [out.json]
Env:   PE_DR0=5,10  PE_STEPS=500  PE_TRAIN=1000 (n_valid max(50, n/20))
       PE_MC_B=32  PE_SKIP_TUNED=1  PE_TUNED_DR0=5,10
       PE_STAGES=ref,mc,periodic,tuned  -- a subset of the stages; with
       out.json given and holding a report of the same device,
       resolution, split, steps and PE_MC_B, the run merges into its
       rows (SECTIONS); another is not merged
       PE_DEVICE=cuda (the card unless "cpu" is named)
The report is printed, and written only to the out.json given.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np
import torch

from ..models import pipeline
from ..parallel import montecarlo
from ..utils.config import SystemConfig
from . import _protocol as P
from .protocol_sweep import reference_scenarios, tuned_build, tuned_row

# the report's row sections, which a staged run merges (the rest is the
# fresh run's metadata)
SECTIONS = ("conditional_build_s", "conditional_var", "conditional_loop_s",
            "conditional_solves_per_s", "reference_rows", "monte_carlo",
            "periodic_build_s", "periodic_loop_s", "periodic_rows",
            "quality_delta_strehl", "tuned_rows")


def sim_cfg(resolution: int, n_steps: int | None, n_train: int | None,
            flow: str) -> SystemConfig:
    """reference_config(resolution) on ``flow`` with n_steps steps and,
    when n_train is given, the split n_train / max(50, n_train // 20)."""
    return P.protocol_cfg(
        resolution, n_steps, n_train=n_train,
        n_valid=max(50, n_train // 20) if n_train else 50, flow=flow)


def edge_rows(system, cfg: SystemConfig, scen, dev):
    """The closed loop of ``scen`` on the build's one shared conditional
    realization, timed.  Returns (outputs, seconds)."""
    t0 = time.time()
    out = montecarlo.run_batch(
        system.loop, system.layers, cfg, scen, n_steps=cfg.sim.n_test,
        edge_model=system.edge_model, edge_state=system.edge_state,
        shared_turbulence=True)
    P.sync(dev)
    return out, time.time() - t0


def main(argv=None, env=None) -> dict:
    """Run the stages; returns the report, prints it, and writes it to
    the out.json argument when one is given."""
    argv = sys.argv[1:] if argv is None else list(argv)
    env = os.environ if env is None else env
    res = int(argv[0]) if argv else 512
    out_path = argv[1] if len(argv) > 1 else None
    dev = P.device(env, "PE_DEVICE")
    d_grid = [float(d) for d in env.get("PE_DR0", "5,10,15,20").split(",")]
    tuned_grid = [float(d) for d in
                  env.get("PE_TUNED_DR0", "5,10").split(",")]
    mc_b = int(env.get("PE_MC_B", "32"))
    stages = set(env.get("PE_STAGES", "ref,mc,periodic,tuned").split(","))
    n_tr = P.env_int(env, "PE_TRAIN")
    cfg = sim_cfg(res, P.env_int(env, "PE_STEPS"), n_tr, "conditional")
    n_steps = cfg.sim.n_test

    report = {
        "protocol": ("README.md:36-37,112-115,277-284 on the reference-"
                     "parity conditional-Gaussian turbulence "
                     "(telescopeAbstract.m:854-884,335-342; "
                     "ops/edge_flow.py)"),
        "resolution": res, "n_steps": n_steps,
        "n_train": cfg.sim.n_train, "n_valid": cfg.sim.n_valid,
        "device": P.device_name(dev),
        "reference_rows": {}, "periodic_rows": {}, "tuned_rows": {},
    }
    P.load_report(out_path, report, SECTIONS,
                  knobs=("resolution", "n_steps", "n_train", "n_valid"),
                  nested={("monte_carlo", "batch"): mc_b})
    scen = reference_scenarios(cfg, d_grid, dev)

    system = None
    if stages & {"ref", "mc"}:
        t0 = time.time()
        system = pipeline.build(cfg, dev)
        P.sync(dev)
        report["conditional_build_s"] = round(time.time() - t0, 1)
        report["conditional_var"] = P.var_validation(cfg, system)

    if "ref" in stages:
        out, t_loop = edge_rows(system, cfg, scen, dev)
        report["conditional_loop_s"] = round(t_loop, 2)
        report["conditional_solves_per_s"] = round(
            len(d_grid) * n_steps / t_loop, 1)
        for i, d in enumerate(d_grid):
            report["reference_rows"][f"d_over_r0={d:g}"] = (
                P.settled_row(out, i))
        print(json.dumps({"reference_rows": report["reference_rows"]}),
              file=sys.stderr, flush=True)
        P.save_report(report, out_path)

    if "mc" in stages:
        scen_mc = montecarlo.make_scenarios(
            cfg, torch.Generator().manual_seed(2), mc_b, device=dev)
        out_mc, t_mc = edge_rows(system, cfg, scen_mc, dev)
        sx = P.host(out_mc.strehl_exact)[:, n_steps // 2:]
        per_scen = sx.mean(axis=1)
        report["monte_carlo"] = {
            "batch": mc_b, "d_over_r0": 5.0,
            "loop_s": round(t_mc, 2),
            "solves_per_s": round(mc_b * n_steps / t_mc, 1),
            "mean_strehl": round(float(per_scen.mean()), 4),
            "p10_strehl": round(float(np.percentile(per_scen, 10)), 4),
            "min_strehl": round(float(per_scen.min()), 4),
        }
        print(json.dumps({"monte_carlo": report["monte_carlo"]}),
              file=sys.stderr, flush=True)
        P.save_report(report, out_path)
    del system

    if "periodic" in stages:
        cfg_p = sim_cfg(res, n_steps, n_tr, "periodic")
        t0 = time.time()
        system_p = pipeline.build(cfg_p, dev)
        P.sync(dev)
        report["periodic_build_s"] = round(time.time() - t0, 1)
        t0 = time.time()
        out_p = montecarlo.run_batch(system_p.loop, system_p.layers, cfg_p,
                                     scen, n_steps=n_steps,
                                     shared_window=True)
        P.sync(dev)
        report["periodic_loop_s"] = round(time.time() - t0, 2)
        del system_p
        for i, d in enumerate(d_grid):
            report["periodic_rows"][f"d_over_r0={d:g}"] = (
                P.settled_row(out_p, i))
        if report["reference_rows"]:
            report["quality_delta_strehl"] = {
                k: round(row["mean_strehl"]
                         - report["periodic_rows"][k]["mean_strehl"], 4)
                for k, row in report["reference_rows"].items()
                if k in report["periodic_rows"]}
        print(json.dumps({"periodic_rows": report["periodic_rows"],
                          "delta": report.get("quality_delta_strehl")}),
              file=sys.stderr, flush=True)
        P.save_report(report, out_path)

    if "tuned" in stages and not env.get("PE_SKIP_TUNED"):
        for d in tuned_grid:
            row, _ = tuned_row(*tuned_build(cfg, d, dev), dev)
            report["tuned_rows"][f"d_over_r0={d:g}"] = row
            print(json.dumps({f"tuned d={d:g}": row}), file=sys.stderr,
                  flush=True)
            P.save_report(report, out_path)

    P.save_report(report, out_path)
    print(json.dumps(report, indent=2))
    return report


if __name__ == "__main__":
    main()
