"""Single-scenario (B=1) closed-loop step latency against the 5 ms budget
of a 200 Hz loop (port of the repository's ``benchmarks/latency_b1.py``).

Every headline number is batch throughput; this records the B=1 time
a control step takes: closed_loop.simulate over ONE scenario for
LAT_STEPS steps on the shared test window (reference_config(R), n_train
300, n_valid 50, BENCH_GN Gauss-Newton passes).  Two figures a row:

  ms_per_step_b1       CUDA events around each run (utils/profiling.
                       cuda_times_ms: LAT_REPEATS repeats after a warm-up
                       run), over the steps: the median, and the IQR of
                       the repeats;
  host_ms_per_step_b1  the host clock around each warm run, a device
                       synchronize after it, over the steps: what a
                       real-time loop driven from the host feels.  A B=1
                       step is launch-bound, so the two are close.

``meets_200hz`` and ``x_under_budget`` read the host-clock figure.  On
the card the row also counts B1's launches a step (exactly 1 + BENCH_GN).
On the CPU no device time exists: ms_per_step_b1 and iqr_ms are null.

Usage: python -m mpc_sensorlessao_tpu_torch.benchmarks.latency_b1 [out.json]
Env:   LAT_RES=128,512  LAT_STEPS=200  LAT_REPEATS=9  BENCH_GN=0
       LAT_DEVICE=cuda (the card unless "cpu" is named)
The report is printed, and written only to the out.json given.
"""

from __future__ import annotations

import dataclasses
import json
import os
import statistics
import sys

import numpy as np

from ..models import closed_loop, pipeline
from ..ops import psf_kernels
from ..utils import profiling
from ..utils.config import SystemConfig, reference_config
from . import _protocol as P

BUDGET_MS = 5.0          # one control step at 200 Hz (README.md:36)


def latency_cfg(resolution: int, gn: int) -> SystemConfig:
    cfg = reference_config(resolution=resolution)
    return cfg.replace(
        sim=dataclasses.replace(cfg.sim, n_train=300, n_valid=50),
        estimator=dataclasses.replace(cfg.estimator, gauss_newton_iters=gn))


def step_run(system, cfg: SystemConfig, steps: int, generator=None,
             noise_seq=None):
    """The B=1 closed loop for ``steps`` steps from the test split, its
    noise from ``generator`` (or the injected ``noise_seq``, (T, p))."""
    return closed_loop.simulate(
        system.loop, system.layers, cfg, generator, n_steps=steps,
        start_step=cfg.sim.n_train + cfg.sim.n_valid, noise_seq=noise_seq)


def _iqr(v) -> list:
    return [round(float(np.percentile(v, 25)), 4),
            round(float(np.percentile(v, 75)), 4)]


def row(resolution: int, steps: int, repeats: int, gn: int, dev) -> dict:
    """One resolution's row: build, a warm-up run (kernels built at first
    use), B1's launches in one run (card only), the CUDA-event and the
    host-clock ms a step."""
    cfg = latency_cfg(resolution, gn)
    system = pipeline.build(cfg, dev)
    gen = P.generator(dev, 1)

    def run():
        return step_run(system, cfg, steps, gen)
    run()
    P.sync(dev)
    out = {}
    if dev.type == "cuda":
        b1 = psf_kernels.psf_crop_diversity_sym3
        before = b1.launches
        run()
        P.sync(dev)
        out["b1_launches_per_step"] = (b1.launches - before) / steps
        ev = [t / steps for t in profiling.cuda_times_ms(run, 1, repeats)]
        out["ms_per_step_b1"] = round(statistics.median(ev), 4)
        out["iqr_ms"] = _iqr(ev)
    else:
        out["ms_per_step_b1"] = out["iqr_ms"] = None
    host = [t / steps for t in P.host_times_ms(run, dev, repeats)]
    ms = statistics.median(host)
    out.update({
        "host_ms_per_step_b1": round(ms, 4),
        "host_iqr_ms": _iqr(host),
        "budget_ms": BUDGET_MS,
        "x_under_budget": round(BUDGET_MS / ms, 1),
        "meets_200hz": bool(ms < BUDGET_MS),
    })
    return out


def main(argv=None, env=None) -> dict:
    """Time every resolution; returns the report, prints it, and writes it
    to the out.json argument when one is given."""
    argv = sys.argv[1:] if argv is None else list(argv)
    env = os.environ if env is None else env
    out_path = argv[0] if argv else None
    dev = P.device(env, "LAT_DEVICE")
    res_grid = [int(r) for r in env.get("LAT_RES", "128,512").split(",")]
    steps = int(env.get("LAT_STEPS", "200"))
    repeats = int(env.get("LAT_REPEATS", "9"))
    gn = int(env.get("BENCH_GN", "0"))

    report = {
        "what": ("B=1 closed-loop control-step latency: CUDA events "
                 "around each run and the host clock around each warm, "
                 "synchronized run, over the steps (median and IQR over "
                 "repeats); budget = 5 ms at 200 Hz (README.md:36)"),
        "steps": steps, "repeats": repeats, "gauss_newton_iters": gn,
        "device": P.device_name(dev), "rows": {},
    }
    for res in res_grid:
        r = row(res, steps, repeats, gn, dev)
        report["rows"][f"R={res}"] = r
        print(json.dumps({f"R={res}": r}), file=sys.stderr, flush=True)
    P.save_report(report, out_path)
    print(json.dumps(report, indent=2))
    return report


if __name__ == "__main__":
    main()
