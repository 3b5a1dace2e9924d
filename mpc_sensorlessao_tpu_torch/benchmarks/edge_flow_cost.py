"""Per-step cost of the conditional-Gaussian frozen flow on the card (port
of the repository's ``benchmarks/edge_flow_cost.py``).

The periodic sampled flow (ops/phase_screens.py) is the fast path; the
conditional-Gaussian border extension (ops/edge_flow.py) is the
reference-parity stochastic flow (telescopeAbstract.m:823-901).  This
measures both inside the whole closed loop (pipeline.run_closed_loop,
one scenario), so the number is the real marginal cost of choosing
reference-parity turbulence: the best of 3 warm runs on the host clock,
each ended by a device synchronize, every run on the noise of a
generator seeded 1.  ``device`` is the card's name and power limit.

Usage: python -m mpc_sensorlessao_tpu_torch.benchmarks.edge_flow_cost
       [resolution] [steps]
Env:   EFC_DEVICE=cuda (the card unless "cpu" is named)
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys

import torch

from ..models import pipeline
from ..utils.config import SystemConfig, reference_config
from . import _protocol as P

FLOWS = ("periodic", "conditional")


def flow_cfg(res: int, steps: int, flow: str) -> SystemConfig:
    """reference_config(res) on ``flow`` with the 300 / 50 ID split and
    ``steps`` test steps (edge_flow_cost.py:44-48)."""
    cfg = reference_config(resolution=res)
    return cfg.replace(
        atmosphere=dataclasses.replace(cfg.atmosphere, flow=flow),
        sim=dataclasses.replace(cfg.sim, n_train=300, n_valid=50,
                                n_test=steps))


def main(argv=None, env=None) -> dict:
    """Time both flows; returns the report and prints it."""
    argv = sys.argv[1:] if argv is None else list(argv)
    env = os.environ if env is None else env
    dev = P.device(env, "EFC_DEVICE")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    res = int(argv[0]) if len(argv) > 0 else 128
    steps = int(argv[1]) if len(argv) > 1 else 500
    report = {"resolution": res, "steps": steps,
              "device": P.device_name(dev)}
    for flow in FLOWS:
        cfg = flow_cfg(res, steps, flow)
        system = pipeline.build(cfg, dev)

        last = []

        def run():
            last[:] = [pipeline.run_closed_loop(system, cfg,
                                                P.generator(dev, 1))]
        run()
        best = min(P.host_times_ms(run, dev, 3)) / 1e3
        out = last[0]
        report[flow] = {
            "loop_s": round(best, 4),
            "us_per_step": round(best / steps * 1e6, 1),
            "mean_strehl": round(
                float(out.strehl_exact[steps // 2:].mean()), 4),
        }
        print(flow, report[flow], file=sys.stderr)
    report["conditional_overhead_us_per_step"] = round(
        report["conditional"]["us_per_step"]
        - report["periodic"]["us_per_step"], 1)
    print(json.dumps(report, indent=2))
    return report


if __name__ == "__main__":
    main()
