"""Multi-process run of the scenario-sharded runner, held to one process
(the correctness mode of the repository's
``benchmarks/multiprocess_cpu.py``).

N spawned ranks (parallel/multihost.spawn) build the same system and the
same global scenario batch, each from its seed, and run
``montecarlo.run_sharded`` over it: every rank its contiguous rows, the
statistics reduced across the processes.  Rank 0 then runs the same
scenarios alone (``run_batch`` over the global batch and the same
reduction, ``montecarlo.reduce_stats``) and requires the means within
rtol 1e-4 and equal scenario and divergence counts.

    python -m mpc_sensorlessao_tpu_torch.benchmarks.multiprocess [out.json]

Env: MP_RES=64 MP_STEPS=20 MP_SPD=4 (scenarios a rank) MP_NPROC=2
     MP_DEVICE=cuda (a card a rank; "cuda:0" puts every rank on card 0,
     then MP_BACKEND=gloo: NCCL refuses two ranks on one card; "cpu"
     runs CPU ranks over gloo) MP_BACKEND (default: the device's)
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import time

import torch

from ..models import pipeline
from ..ops import psf_kernels
from ..parallel import mesh as mesh_lib
from ..parallel import montecarlo, multihost
from ..utils import checkpoint
from ..utils.config import reference_config

RTOL = 1e-4
MEANS = ("mean_rms_res", "mean_rms_turb", "mean_strehl",
         "mean_strehl_exact")


def bench_system_cfg(resolution: int, n_steps: int):
    cfg = reference_config(resolution=resolution)
    return cfg.replace(sim=dataclasses.replace(
        cfg.sim, n_train=300, n_valid=50, n_test=n_steps))


def save_system(path: str, system: pipeline.System, cfg) -> None:
    """Checkpoint what a rank needs to run the loop: the loop operators,
    the screens and the config."""
    checkpoint.save(path, {"loop": system.loop, "layers": system.layers,
                           "cfg": cfg}, overwrite=True)


def max_rel_delta(got: dict, want: dict) -> float:
    """The largest relative difference of the means; raises unless
    within RTOL and the counts are equal."""
    rel = {k: abs(got[k] - want[k]) / (abs(want[k]) + 1e-12) for k in MEANS}
    for k in ("n_scenarios", "n_diverged"):
        if got[k] != want[k]:
            raise AssertionError(f"{k}: sharded {got[k]} != one process "
                                 f"{want[k]}")
    for k, r in rel.items():
        if r > RTOL:
            raise AssertionError(f"{k}: sharded {got[k]} vs one process "
                                 f"{want[k]} (relative {r:.3g} > {RTOL})")
    return max(rel.values())


def sharded_stats(rank: int, world: int, device: torch.device,
                  job: dict) -> dict:
    """One rank: the system restored from ``job["system_dir"]`` (a
    save_system checkpoint) or else built at ``job["resolution"]``; the
    global batch of ``job["n_scenarios"]`` shared-window scenarios over
    ``job["d_grid"]`` x ``job["snr_grid"]`` from seed ``job["seed"]``;
    ``run_sharded`` for ``job["n_steps"]`` steps, then ``job["timed"]``
    warm runs on the host clock.  Returns the statistics, the warm
    seconds and B1's launches in the first run; with
    ``job["reference"]`` rank 0 also runs the batch alone and holds the
    two (max_rel_delta)."""
    if job.get("system_dir"):
        tree = checkpoint.restore(job["system_dir"], device=device)
        loop, layers, cfg = tree["loop"], tree["layers"], tree["cfg"]
    else:
        cfg = bench_system_cfg(job["resolution"], job["n_steps"])
        system = pipeline.build(cfg, device)
        loop, layers = system.loop, system.layers
    scen = montecarlo.make_scenarios(
        cfg, torch.Generator().manual_seed(job["seed"]), job["n_scenarios"],
        d_over_r0_grid=job["d_grid"], snr_db_grid=job["snr_grid"],
        device=device)
    mesh = mesh_lib.scenario_mesh(device_type=device.type)
    runner = montecarlo.make_sharded_runner(loop, layers, cfg,
                                            job["n_steps"], mesh,
                                            shared_window=True)
    b1 = psf_kernels.psf_crop_diversity_sym3
    b1.launches = 0
    stats = runner(scen).as_floats()
    out = {"stats": stats, "launches": b1.launches, "warm_s": []}
    for _ in range(job.get("timed", 0)):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        float(runner(scen).mean_rms_res)
        out["warm_s"].append(time.perf_counter() - t0)
    if job.get("reference") and rank == 0:
        one = montecarlo.run_batch(loop, layers, cfg, scen, job["n_steps"],
                                   shared_window=True)
        out["stats_single"] = montecarlo.reduce_stats(
            one, job["n_steps"]).as_floats()
        out["max_rel_delta"] = max_rel_delta(stats, out["stats_single"])
    return out


def main(argv=None) -> dict:
    argv = sys.argv[1:] if argv is None else list(argv)
    env = os.environ
    nproc = int(env.get("MP_NPROC", "2"))
    device = env.get("MP_DEVICE", "cuda")
    job = {"resolution": int(env.get("MP_RES", "64")),
           "n_steps": int(env.get("MP_STEPS", "20")),
           "n_scenarios": int(env.get("MP_SPD", "4")) * nproc,
           "d_grid": (5.0, 10.0), "snr_grid": (5.0, 10.0), "seed": 1,
           "reference": True}
    t0 = time.time()
    ranks = multihost.spawn(sharded_stats, nproc,
                            backend=env.get("MP_BACKEND"), device=device,
                            args=(job,))
    r0 = ranks[0]
    report = {
        "what": ("multi-process torch.distributed run of "
                 "parallel/montecarlo.run_sharded: statistics held to "
                 "one process's run of the same scenarios"),
        "resolution": job["resolution"], "n_steps": job["n_steps"],
        "n_scenarios": job["n_scenarios"], "num_processes": nproc,
        "device": device,
        "backend": env.get("MP_BACKEND") or multihost.default_backend(
            device),
        "wall_s": time.time() - t0,
        "stats_single": r0["stats_single"], "stats_multi": r0["stats"],
        "max_rel_delta": r0["max_rel_delta"], "ok": True,
    }
    if argv:
        with open(argv[0], "w") as f:
            json.dump(report, f, indent=2)
            f.write("\n")
    return report


if __name__ == "__main__":
    print(json.dumps(main(), indent=2))
