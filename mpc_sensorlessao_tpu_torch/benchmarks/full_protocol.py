"""The full reference experimental protocol, end to end (port of the
repository's ``benchmarks/full_protocol.py``).

The reference's complete workflow at its real scale
(README.md:36-37,112-115,339): 2000 frames at 200 Hz (1000 train / 500
valid / 500 test), VAR(2) identification with held-out validation
RMSE/RRMSE, then the 500-step closed-loop MPC run -- over a Monte-Carlo
batch of noise realizations (make_scenarios: D/r0=5, SNR 10 dB, the
shared test window), summarized (metrics.summarize) and checked
(guards.check_outputs).

The scenarios are drawn from a CPU generator seeded 1 and their noise
from a device generator (the JAX PRNGKey(1) streams cannot be
reproduced).  The loop time is one run after a device synchronize,
the kernels' first-use build included (the JAX script times its first,
compiling call).

Usage: python -m mpc_sensorlessao_tpu_torch.benchmarks.full_protocol
       [resolution] [batch]
Env:   FP_DEVICE=cuda (the card unless "cpu" is named)
Prints one JSON report.
"""

from __future__ import annotations

import json
import os
import sys
import time

import torch

from ..models import pipeline
from ..parallel import montecarlo
from ..utils import guards, metrics
from ..utils.config import reference_config
from . import _protocol as P


def main(argv=None, env=None) -> dict:
    """Run the protocol; returns the report and prints it."""
    argv = sys.argv[1:] if argv is None else list(argv)
    env = os.environ if env is None else env
    res = int(argv[0]) if argv else 128
    batch = int(argv[1]) if len(argv) > 1 else 32
    dev = P.device(env, "FP_DEVICE")
    cfg = reference_config(resolution=res)   # full 1000/500/500 protocol

    t0 = time.time()
    system = pipeline.build(cfg, dev)
    P.sync(dev)
    t_build = time.time() - t0
    val = P.var_validation(cfg, system, digits=None)

    scen = montecarlo.make_scenarios(cfg, torch.Generator().manual_seed(1),
                                     batch, device=dev)
    t0 = time.time()
    out = montecarlo.run_batch(system.loop, system.layers, cfg, scen,
                               n_steps=cfg.sim.n_test, shared_window=True)
    P.sync(dev)
    t_loop = time.time() - t0

    summary = metrics.to_dict(metrics.summarize(out))
    health = guards.check_outputs(out, u_max=cfg.mpc.u_max)
    report = {
        "resolution": res,
        "batch": batch,
        "n_steps": cfg.sim.n_test,
        "build_s": round(t_build, 1),
        "loop_s": round(t_loop, 2),
        "solves_per_s": round(batch * cfg.sim.n_test / t_loop, 1),
        "var_rmse_mean": val["var_rmse_mean"],
        "var_rrmse_mean": val["var_rrmse_mean"],
        "health": str(health),
        **{k: round(v, 4) for k, v in summary.items()},
        "device": P.device_name(dev),
    }
    print(json.dumps(report, indent=2))
    return report


if __name__ == "__main__":
    main()
