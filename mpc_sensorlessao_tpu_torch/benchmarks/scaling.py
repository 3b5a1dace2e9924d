"""Scenario-parallel scaling-efficiency report over worlds of ranks (port
of the repository's ``benchmarks/scaling.py``).

BASELINE asks for solves/s efficiency at 1 chip / 1 host / N hosts.
This builds reference_config(64) once, checkpoints what a rank needs
(multiprocess.save_system) and, for each world size in {1, n/2, n},
spawns one world of that many ranks (multihost.spawn; a DeviceMesh must
span its world, so each size is a world of its own), each rank running
montecarlo.run_sharded over its rows of scenarios_per_rank x size
shared-window scenarios: a warm-up run, then the best of 3 host-clock
runs (each ended by the run's collective and a synchronize, rank 0's
clock).  Efficiency at size k is rate_k / (k rate_1).

The ranks' devices come from SCALING_DEVICE: "cuda" gives each rank its
own card (NCCL; n = the number of cards), "cuda:k" puts every rank on
card k and "cpu" runs CPU ranks (both over gloo; n = SCALING_RANKS, the
counterpart of the JAX run's virtual device count).  ``cross_card`` says
whether a world spanned more than one card: ranks that share a card
measure the runner's overhead, not cross-card scaling.  On the card the
report also counts B1's launches in each rank's first run.  ``device``
is the card's name and power limit.

Usage: python -m mpc_sensorlessao_tpu_torch.benchmarks.scaling
       [scenarios_per_rank] [steps] [out.json]
Env:   SCALING_DEVICE=cuda  SCALING_RANKS (for "cuda:k" and "cpu"; 1)
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import tempfile

import torch

from ..models import pipeline
from ..parallel import multihost
from ..utils.config import SystemConfig, reference_config
from . import _protocol as P
from . import multiprocess

RESOLUTION = 64
TIMED = 3


def scaling_cfg(steps: int) -> SystemConfig:
    """reference_config(64) with the 300 / 50 ID split and ``steps`` test
    steps (scaling.py:35-37)."""
    cfg = reference_config(resolution=RESOLUTION)
    return cfg.replace(sim=dataclasses.replace(
        cfg.sim, n_train=300, n_valid=50, n_test=steps))


def world_sizes(n: int) -> list:
    return sorted({1, max(n // 2, 1), n})


def world_rate(system_dir: str, size: int, per_rank: int, steps: int,
               device: str) -> tuple[float, list]:
    """One world of ``size`` ranks on ``device`` (multihost.spawn's
    meaning) running the checkpointed system: its solves/s (rank 0's best
    warm run) and each rank's B1 launches in its first run."""
    backend = None if device == "cuda" else "gloo"
    job = {"system_dir": system_dir, "n_scenarios": per_rank * size,
           "n_steps": steps, "d_grid": (5.0,), "snr_grid": (10.0,),
           "seed": 1, "timed": TIMED}
    ranks = multihost.spawn(multiprocess.sharded_stats, size,
                            backend=backend, device=device, args=(job,))
    return (per_rank * size * steps / min(ranks[0]["warm_s"]),
            [r["launches"] for r in ranks])


def scaling(system, cfg: SystemConfig, per_rank: int, steps: int, n: int,
            device: str) -> tuple[dict, dict]:
    """solves/s and B1 launches a rank by world size, over sizes {1, n/2,
    n}."""
    rates, launches = {}, {}
    with tempfile.TemporaryDirectory(prefix="mpcsao_scaling_") as tmp:
        system_dir = os.path.join(tmp, "system")
        multiprocess.save_system(system_dir, system, cfg)
        for nd in world_sizes(n):
            rates[nd], launches[nd] = world_rate(system_dir, nd, per_rank,
                                                 steps, device)
            eff = rates[nd] / (rates[1] * nd)
            print(f"devices={nd:2d} scenarios={per_rank * nd:4d}: "
                  f"{rates[nd]:,.0f} solves/s  efficiency={eff * 100:.0f}%",
                  file=sys.stderr, flush=True)
    return rates, launches


def main(argv=None, env=None) -> dict:
    """Build, run every world size; returns the report, and writes it to
    the out.json argument when one is given."""
    argv = sys.argv[1:] if argv is None else list(argv)
    env = os.environ if env is None else env
    per_rank = int(argv[0]) if len(argv) > 0 else 8
    steps = int(argv[1]) if len(argv) > 1 else 20
    out_path = argv[2] if len(argv) > 2 else None
    device = env.get("SCALING_DEVICE", "cuda")
    dev = P.device(env, "SCALING_DEVICE")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    own_cards = device == "cuda"
    n = (torch.cuda.device_count() if own_cards
         else int(env.get("SCALING_RANKS", "1")))

    cfg = scaling_cfg(steps)
    system = pipeline.build(cfg, dev)
    rates, launches = scaling(system, cfg, per_rank, steps, n, device)
    report = {
        "platform": dev.type,
        "device": P.device_name(dev),
        "n_devices": n,
        "cross_card": own_cards and n > 1,
        "scenarios_per_device": per_rank,
        "steps": steps,
        "solves_per_s": {str(k): round(v, 1) for k, v in rates.items()},
        "efficiency": {str(k): round(v / (rates[1] * k), 4)
                       for k, v in rates.items()},
    }
    if dev.type == "cuda":
        report["b1_launches"] = {str(k): v for k, v in launches.items()}
    P.save_report(report, out_path)
    return report


if __name__ == "__main__":
    print(json.dumps(main(), indent=2))
