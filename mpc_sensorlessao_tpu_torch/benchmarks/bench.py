"""Benchmark: end-to-end MPC control-step throughput on the card (port of
the repository's ``bench.py``).

Each "solve" is one full sensorless-AO control step -- frozen-flow
turbulence evolution, 3-diversity PSF formation (kernel B1), linear LS
estimate, condensed-QP assembly and the fixed-barrier Newton-KKT fastMPC
solve, DM modal correction -- batched over Monte-Carlo scenarios that
share one turbulence window (montecarlo.run_batch(shared_window=
"verified")).

Baseline: the reference's implied real-time budget of 200 Hz (5 ms per
control step, README.md:36; BASELINE.md) -> vs_baseline = solves_per_s/200.

Prints ONE JSON line on stdout: {"metric", "value", "unit",
"vs_baseline"}; the run's meta on stderr.  ``compile_s`` is the first
run's seconds: on the card the kernels' nvcc build at first use (unless
build/kernels/ already holds them) and the warm-up; ``run_s`` is the
best of BENCH_REPEATS host-clock runs, each ended by a device
synchronize.  ``device`` is the card's name and power limit (nvidia-smi).
TF32 stays off.

Usage: python -m mpc_sensorlessao_tpu_torch.benchmarks.bench
Env:   BENCH_RES (128), BENCH_BATCH (4096), BENCH_STEPS (25),
       BENCH_SOLVER (fastmpc), BENCH_REPEATS (3), BENCH_DFT_DTYPE
       (float32 | bfloat16 measurement matmuls), BENCH_GN (0),
       BENCH_DEVICE (cuda: the card unless "cpu" is named)
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import time

import torch

from ..models import pipeline
from ..parallel import montecarlo
from ..utils.config import SystemConfig, reference_config
from . import _protocol as P


def bench_cfg(res: int, steps: int, dft_dtype: str, gn: int) -> SystemConfig:
    """reference_config(res) with the bench's shorter ID pre-pass (the
    benchmark measures the closed loop), ``steps`` test steps, the DFT
    dtype and ``gn`` Gauss-Newton passes (bench.py:53-60)."""
    cfg = reference_config(resolution=res)
    return cfg.replace(
        sim=dataclasses.replace(cfg.sim, n_train=300, n_valid=50,
                                n_test=steps),
        estimator=dataclasses.replace(cfg.estimator, dft_dtype=dft_dtype,
                                      gauss_newton_iters=gn))


def main(argv=None, env=None) -> tuple[dict, dict]:
    """Build, run once, time the best of the repeats; prints the result
    line on stdout and the meta on stderr, and returns (line, meta)."""
    env = os.environ if env is None else env
    dev = P.device(env, "BENCH_DEVICE")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    res = int(env.get("BENCH_RES", "128"))
    # B=4096 measured best-value batch at R=128 (BENCH_MAX_r03.json);
    # R=512 rows must keep B<=256
    batch = int(env.get("BENCH_BATCH", "4096"))
    steps = int(env.get("BENCH_STEPS", "25"))
    solver = env.get("BENCH_SOLVER", "fastmpc")
    repeats = int(env.get("BENCH_REPEATS", "3"))
    dft_dtype = env.get("BENCH_DFT_DTYPE", "float32")
    # 0 = the reference's linear-LS estimator exactly (README.md:478);
    # each extra iteration re-runs the fused PSF measure once more a step
    gn = int(env.get("BENCH_GN", "0"))
    cfg = bench_cfg(res, steps, dft_dtype, gn)

    t0 = time.time()
    system = pipeline.build(cfg, dev)
    P.sync(dev)
    build_s = time.time() - t0

    scen = montecarlo.make_scenarios(
        cfg, torch.Generator().manual_seed(1), batch,
        d_over_r0_grid=(5.0,), snr_db_grid=(10.0,), device=dev)
    # every bench scenario uses the same turbulence window: the frozen
    # flow is sampled once a step, not per scenario
    montecarlo.assert_shared_window(scen)

    def run():
        return montecarlo.run_batch(system.loop, system.layers, cfg, scen,
                                    n_steps=steps, solver=solver,
                                    shared_window="verified")

    t0 = time.time()
    out = run()
    P.sync(dev)
    compile_s = time.time() - t0

    times = []
    for _ in range(repeats):
        t0 = time.time()
        out = run()
        P.sync(dev)
        times.append(time.time() - t0)
    best = min(times)
    solves_per_s = batch * steps / best

    meta = {
        "build_s": round(build_s, 2),
        "compile_s": round(compile_s, 2),
        "run_s": round(best, 4),
        "resolution": res,
        "batch": batch,
        "steps": steps,
        "solver": solver,
        "gauss_newton_iters": gn,
        "device": P.device_name(dev),
        # exact OTF-volume Strehl (imager.m:115) is the headline metric;
        # the Marechal approximation is kept for comparison
        "mean_strehl": float(torch.mean(out.strehl_exact[:, steps // 2:])),
        "mean_strehl_marechal": float(torch.mean(
            out.strehl[:, steps // 2:])),
        "mean_rms_res": float(torch.mean(out.rms_res[:, steps // 2:])),
    }
    print(json.dumps(meta), file=sys.stderr)
    line = {
        "metric": "mpc_control_steps_per_s",
        "value": round(solves_per_s, 1),
        "unit": "solves/s",
        "vs_baseline": round(solves_per_s / 200.0, 2),
    }
    print(json.dumps(line))
    return line, meta


if __name__ == "__main__":
    main()
