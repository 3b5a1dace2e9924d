"""100k-scenario Monte-Carlo closed loop on one device (BASELINE config 5
scale; port of the repository's ``benchmarks/montecarlo_100k.py``).

The population: D/r0 x SNR cells x thousands of noise seeds per cell on
the shared turbulence window, in chunks, with only per-scenario settled
summaries leaving the device.  Per D/r0 one tuned build (the mmse prior
scale depends on d): radial order 10, mmse with prior_scale
min(0.15, 0.5/d), warm start, var_ridge 1e-2, r_weight 30, n_train 300,
n_valid 50; the scenarios of a chunk are SNR x seeds.

Checkpoint/resume: with MC1_CKPT=<dir> the per-chunk settled summaries
[d, chunk, (strehl|rms|turb), scenario] and a cursor are saved
(utils/checkpoint, atomically) after every chunk; --resume restores them
and skips the chunks done.  A chunk's measurement noise is seeded from
its index only, so an interrupted and resumed sweep is bit-identical to
an uninterrupted one.  MC1_STOP_AFTER=<k> stops (exit code 3) after k
chunks of this run, the checkpoint saved: the kill half of that check.

Usage: python -m mpc_sensorlessao_tpu_torch.benchmarks.montecarlo_100k
       [resolution] [out.json] [--resume]
Env:   MC1_DR0=5,10,15,20  MC1_SNR=5,10,20,40  MC1_REPS=6400
       MC1_STEPS=100  MC1_CHUNK=1600  MC1_CKPT=dir  MC1_STOP_AFTER=k
       MC1_DEVICE=cuda (the card unless "cpu" is named)
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np
import torch

from ..models import closed_loop, pipeline
from ..utils import checkpoint, profiling
from ..utils.config import SystemConfig, mag_conv
from . import _protocol

STOPPED = 3        # exit code of a run stopped by MC1_STOP_AFTER


def tuned_cfg(resolution: int, d: float, n_steps: int) -> SystemConfig:
    """The per-D/r0 tuned build of the population (the protocols' tuned
    recipe on the 300/50 split)."""
    return _protocol.tuned_cfg(
        _protocol.protocol_cfg(resolution, n_steps, n_train=300, n_valid=50),
        d)


def chunk_seed(chunk: int) -> int:
    """The measurement-noise seed of chunk ``chunk``: from its index only
    (the same for every D/r0, as the JAX script's fold_in(key 1, c))."""
    return int(np.random.SeedSequence([1, chunk]).generate_state(
        1, np.uint64)[0] >> np.uint64(1))


def run_chunk(system: pipeline.System, cfg: SystemConfig, start: float,
              mag: float, noise_scale: torch.Tensor, init_u: torch.Tensor,
              n_steps: int, noise_seed: int | None = None,
              noise_seq: torch.Tensor | None = None) -> np.ndarray:
    """One chunk: the closed loop of len(noise_scale) scenarios on the
    shared window from ``start``, their noise from ``noise_seed`` (or the
    injected ``noise_seq``, (B, T, p)); returns the per-scenario settled
    (steps n_steps//2:) means (3, B) of exact Strehl, residual RMS and
    turbulence RMS -- all that leaves the device."""
    gen = None
    if noise_seq is None:
        gen = torch.Generator(device=noise_scale.device)
        gen.manual_seed(noise_seed)
    out = closed_loop.simulate(system.loop, system.layers, cfg, gen,
                               n_steps=n_steps, start_step=start, mag=mag,
                               noise_scale=noise_scale, noise_seq=noise_seq,
                               init_u=init_u)
    settle = n_steps // 2
    return torch.stack([out.strehl_exact[:, settle:].mean(dim=1),
                        out.rms_res[:, settle:].mean(dim=1),
                        out.rms_turb[:, settle:].mean(dim=1)]).cpu().numpy()


def cells(summaries: np.ndarray, d_grid, snr_grid, chunk_reps: int) -> dict:
    """Per (D/r0, SNR) cell: count, diverged (non-finite, or residual over
    3x the turbulence), and the kept scenarios' mean / p10 / min settled
    Strehl and mean residual and turbulence RMS."""
    out = {}
    for d_idx, d in enumerate(d_grid):
        for s_idx, s in enumerate(snr_grid):
            sl = slice(s_idx * chunk_reps, (s_idx + 1) * chunk_reps)
            sx, rr, rt = (summaries[d_idx, :, k, sl].ravel()
                          for k in range(3))
            finite = np.isfinite(rr) & np.isfinite(sx)
            diverged = (~finite) | (rr > 3.0 * rt)
            okv = sx[~diverged]
            cell = {"n": int(sx.size), "n_diverged": int(diverged.sum())}
            if okv.size:
                cell.update(
                    mean_strehl=round(float(okv.mean()), 4),
                    p10_strehl=round(float(np.percentile(okv, 10)), 4),
                    min_strehl=round(float(okv.min()), 4),
                    mean_rms_res=round(float(rr[~diverged].mean()), 4),
                    mean_rms_turb=round(float(rt[~diverged].mean()), 4))
            out[f"d={d:g}_snr={s:g}"] = cell
    return out


def main(argv=None, env=None) -> dict:
    """Run the population; returns the report (and writes it to the
    out.json argument).  ``env`` (default os.environ) holds the MC1_*
    knobs.  Raises SystemExit(STOPPED) when MC1_STOP_AFTER stops it."""
    argv = sys.argv[1:] if argv is None else list(argv)
    env = os.environ if env is None else env
    pos = [a for a in argv if not a.startswith("--")]
    res = int(pos[0]) if pos else 64
    out_path = pos[1] if len(pos) > 1 else None
    d_grid = [float(x) for x in env.get("MC1_DR0", "5,10,15,20").split(",")]
    snr_grid = [float(x) for x in
                env.get("MC1_SNR", "5,10,20,40").split(",")]
    reps = int(env.get("MC1_REPS", "6400"))
    n_steps = int(env.get("MC1_STEPS", "100"))
    chunk_reps = int(env.get("MC1_CHUNK", "1600"))
    dev = torch.device(env.get("MC1_DEVICE", "cuda"))
    torch.empty(0, device=dev)          # no such device: raises here
    if reps % chunk_reps:
        raise ValueError(f"MC1_REPS={reps} is not a multiple of "
                         f"MC1_CHUNK={chunk_reps}")
    ckpt_dir = env.get("MC1_CKPT")
    resume = "--resume" in argv
    stop_after = int(env.get("MC1_STOP_AFTER", "0"))
    n_chunks = reps // chunk_reps
    B = len(snr_grid) * chunk_reps
    state = {
        "summaries": np.full((len(d_grid), n_chunks, 3, B), np.nan,
                             np.float32),
        "cursor": np.zeros((), np.int64),
    }
    if resume:
        if not ckpt_dir:
            raise SystemExit("--resume requires MC1_CKPT")
        state = checkpoint.restore(ckpt_dir, like=state)
        print(f"resumed at cursor={int(state['cursor'])}/"
              f"{len(d_grid) * n_chunks}", file=sys.stderr, flush=True)

    n_total = len(d_grid) * len(snr_grid) * reps
    report = {
        "what": (f"{n_total} closed-loop scenarios x {n_steps} steps on "
                 "one device: per-cell mean/p10 settled Strehl, residual "
                 "RMS, divergence count; chunked shared-window batches, "
                 "only per-scenario settled summaries leave the device"),
        "resolution": res, "n_steps": n_steps, "reps_per_cell": reps,
        "chunk_reps": chunk_reps, "n_scenarios": n_total,
        "device": (profiling.card() if dev.type == "cuda" else "cpu"),
        "per_d": {}, "cells": {},
    }
    if ckpt_dir:
        report["checkpoint_dir"] = os.path.abspath(ckpt_dir)
        report["resumed_at_cursor"] = int(state["cursor"])
    t_all = time.time()
    total_loop_s = 0.0
    session_ran = 0

    for d_idx, d in enumerate(d_grid):
        if int(state["cursor"]) >= (d_idx + 1) * n_chunks:
            continue          # d fully restored from the checkpoint
        cfg = tuned_cfg(res, d, n_steps)
        t0 = time.time()
        system = pipeline.build(cfg, dev)
        start = cfg.sim.n_train + cfg.sim.n_valid
        init_u = pipeline.warm_start_command(system, cfg, start)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        build_s = time.time() - t0
        # noise_scale per SNR cell: 10^((SNR_cfg - snr)/20)
        scales = torch.tensor(
            [10.0 ** ((cfg.estimator.snr_db - s) / 20.0) for s in snr_grid],
            dtype=torch.float32)
        scale_col = scales.repeat_interleave(chunk_reps).to(dev)
        t0 = time.time()
        ran_this_d = 0
        for c in range(n_chunks):
            gidx = d_idx * n_chunks + c
            if gidx < int(state["cursor"]):
                continue
            state["summaries"][d_idx, c] = run_chunk(
                system, cfg, float(start), mag_conv(d), scale_col, init_u,
                n_steps, noise_seed=chunk_seed(c))
            state["cursor"] = np.asarray(gidx + 1, np.int64)
            ran_this_d += 1
            session_ran += 1
            if ckpt_dir:
                checkpoint.save(ckpt_dir, state, overwrite=True)
            if stop_after and session_ran >= stop_after:
                print(f"MC1_STOP_AFTER={stop_after}: stopping at cursor "
                      f"{int(state['cursor'])} (checkpoint saved)",
                      file=sys.stderr, flush=True)
                raise SystemExit(STOPPED)
        loop_s = time.time() - t0
        total_loop_s += loop_s
        report["per_d"][f"d={d:g}"] = {
            "build_s": build_s, "loop_s": loop_s, "chunks_run": ran_this_d,
            "solves_per_s": ran_this_d * B * n_steps / max(loop_s, 1e-9)}
        print(json.dumps({f"d={d:g}": report["per_d"][f"d={d:g}"]}),
              file=sys.stderr, flush=True)

    report["cells"] = cells(state["summaries"], d_grid, snr_grid,
                            chunk_reps)
    report["summaries"] = state["summaries"]
    report["total_loop_s"] = total_loop_s
    report["total_wall_s"] = time.time() - t_all
    ran = sum(v["chunks_run"] for v in report["per_d"].values())
    report["aggregate_solves_per_s"] = (ran * B * n_steps
                                        / max(total_loop_s, 1e-9))
    if out_path:
        with open(out_path, "w") as f:
            json.dump({k: v for k, v in report.items() if k != "summaries"},
                      f, indent=2)
            f.write("\n")
    return report


if __name__ == "__main__":
    rep = main()
    print(json.dumps({k: v for k, v in rep.items() if k != "summaries"},
                     indent=2))
