"""Classical SH + integrator loop vs the sensorless MPC loop (port of the
repository's ``benchmarks/classical_vs_mpc.py``).

The paper's core motivation: replace the classical wavefront-sensor +
integrator AO loop with PSF-based sensorless MPC.  This benchmark runs
BOTH controllers on the SAME frozen-flow turbulence window and records
Strehl / residual RMS / rejection per D/r0.

Controllers:
  integrator: Shack-Hartmann geometric slopes (models/wfs.py) ->
      TSVD-calibrated modal command (models/integrator.py
      calibration_vault, controller.m:305-308 update law), gain swept
      over 0.3 / 0.5 / 0.7 and the best recorded.  Two rows: an IDEAL one
      (noiseless slopes, zero extra delay, perfect modal corrector) and a
      noise-matched one whose per-slope SNR equals the MPC estimator's
      configured SNR (sigma = rms(signal slopes) * 10^(-SNR/20)).
  mpc: the full sensorless pipeline (PSF diversity estimator with its
      configured measurement noise, VAR prediction, fastMPC solver),
      measuring through kernel B1 on the card -- the reference recipe at
      D/r0=5 and the strong-turbulence recipe (config.strong_turbulence:
      order 10, mmse with the analytic prior, warm start) at D/r0 >= 10.

The turbulence window comes from the same integer-seeded host screens as
the JAX package's, so it is the same window; the MPC's measurement noise
is drawn from a torch generator seeded 1 and the noise-matched row's
slope noise from one seeded 2 (the JAX PRNGKey(1)/(2) streams cannot be
reproduced).  Every time is taken after a device synchronize.  Besides
the JAX script's keys a row holds every gain's run ("runs"), each part's
launches of B1 ("b1_launches"; counted on the card only), and the MPC
loop's and each integrator run's ms a step.

Usage: python -m mpc_sensorlessao_tpu_torch.benchmarks.classical_vs_mpc
       [resolution] [out.json]
Env:   CVM_DR0=5,10  CVM_STEPS=500  CVM_DEVICE=cuda (the card unless
       "cpu" is named)
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import time

import numpy as np
import torch

from ..models import integrator, pipeline, wfs
from ..ops import phase_screens, psf_kernels
from ..utils import profiling
from ..utils.config import SystemConfig, reference_config, strong_turbulence

GAINS = (0.3, 0.5, 0.7)
WINDOW_CHUNK = 16          # turbulence steps sampled at once


def row_cfg(resolution: int, d_over_r0: float, n_steps: int) -> SystemConfig:
    """reference_config at D/r0 = ``d_over_r0`` with ``n_steps`` test
    steps; from D/r0 = 10 on the strong-turbulence recipe."""
    cfg = reference_config(resolution=resolution)
    if d_over_r0 >= 10:
        cfg = strong_turbulence(cfg, d_over_r0)
    return cfg.replace(sim=dataclasses.replace(
        cfg.sim, d_over_r0=d_over_r0, n_test=n_steps))


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _b1_launches() -> int:
    return psf_kernels.psf_crop_diversity_sym3.launches


def turbulence_window(system: pipeline.System, cfg: SystemConfig,
                      n_steps: int) -> torch.Tensor:
    """(n_steps, R*R) open-loop pupil phases of the test window (from
    n_train + n_valid), piston-removed and magnified as the loop sees
    them, sampled WINDOW_CHUNK steps at a time."""
    loop = system.loop
    dev = loop.mask.device
    start = cfg.sim.n_train + cfg.sim.n_valid
    out = []
    for lo in range(0, n_steps, WINDOW_CHUNK):
        steps = start + torch.arange(lo, min(lo + WINDOW_CHUNK, n_steps),
                                     dtype=torch.float32, device=dev)
        out.append(phase_screens.piston_removed_phase_at(
            system.layers, steps, cfg.resolution, loop.mask,
            loop.mask_npix) * cfg.sim.magnification)
    return torch.cat(out).reshape(n_steps, -1)


def classical_setup(system: pipeline.System, cfg: SystemConfig):
    """The SH sensor (10 lenslets where the grid divides, else 8), the
    loop's Zernike state stack flattened (K, R*R), and the TSVD vault of
    the geometric interaction matrix (modes with s0/s > 100 dropped)."""
    R = cfg.resolution
    sh = wfs.build(R, n_lenslet=10 if R % 10 == 0 else 8,
                   device=system.loop.mask.device)
    stack = system.loop.state_stack
    vault = integrator.calibration_vault(
        wfs.interaction_matrix(sh, stack), cond=100.0)
    return sh, stack.reshape(stack.shape[0], -1), vault


def _marechal(rms: np.ndarray) -> float:
    return float(np.mean(np.exp(-rms[len(rms) // 2:] ** 2)))


def row(cfg: SystemConfig, device: torch.device | str = "cuda") -> dict:
    """One D/r0 row: build, the MPC loop over cfg.sim.n_test steps, and
    the two integrator rows on the same window."""
    dev = torch.device(device)
    n_steps = cfg.sim.n_test
    s = n_steps // 2
    b1 = _b1_launches()
    t0 = time.perf_counter()
    system = pipeline.build(cfg, dev)
    _sync(dev)
    build_s = time.perf_counter() - t0
    b1_build = _b1_launches() - b1

    b1 = _b1_launches()
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    t0 = time.perf_counter()
    out = pipeline.run_closed_loop(system, cfg, gen)
    _sync(dev)
    mpc_s = time.perf_counter() - t0
    res_m = out.rms_res.cpu().numpy()
    turb = out.rms_turb.cpu().numpy()
    turb_mean = float(turb[s:].mean())
    result = {
        "mpc": {
            "mean_rms_res": float(res_m[s:].mean()),
            "rejection": turb_mean / float(res_m[s:].mean()),
            "strehl_exact": float(out.strehl_exact[s:].mean()),
            "strehl_marechal": _marechal(res_m),
            "loop_s": mpc_s,
            "ms_per_step": 1e3 * mpc_s / n_steps,
            "b1_launches": _b1_launches() - b1,
        },
        "mean_rms_turb": turb_mean,
        "build_s": build_s,
        "b1_launches_build": b1_build,
        "runs": {},
    }

    sh, stack_flat, vault = classical_setup(system, cfg)
    flat = turbulence_window(system, cfg, n_steps)
    mask_flat = system.loop.mask.reshape(-1)
    # noise-matched row: per-slope SNR = the estimator's configured SNR
    sig_slopes = torch.sqrt(torch.mean((flat @ sh.slope_op.T) ** 2))
    sigma = float(sig_slopes) * 10.0 ** (-cfg.estimator.snr_db / 20.0)
    gen.manual_seed(2)
    noise = sigma * torch.randn((n_steps, sh.n_slopes), generator=gen,
                                device=dev)
    for label, sl_noise in (("integrator", None),
                            ("integrator_snr_matched", noise)):
        runs = []
        for gain in GAINS:
            t0 = time.perf_counter()
            _, rms = integrator.closed_loop(
                sh.slope_op, vault, stack_flat, flat,
                integrator.IntegratorConfig(gain=gain), mask_flat=mask_flat,
                slope_noise=sl_noise)
            rms = rms.cpu().numpy()
            loop_s = time.perf_counter() - t0
            runs.append({
                "gain": gain,
                "mean_rms_res": float(rms[s:].mean()),
                "rejection": turb_mean / float(rms[s:].mean()),
                "strehl_marechal": _marechal(rms),
                "loop_s": loop_s,
                "ms_per_step": 1e3 * loop_s / n_steps,
            })
        result["runs"][label] = runs
        result[label] = min(runs, key=lambda r: r["mean_rms_res"])
    result["mpc_advantage_rms"] = (result["integrator"]["mean_rms_res"]
                                   / result["mpc"]["mean_rms_res"])
    result["mpc_advantage_rms_snr_matched"] = (
        result["integrator_snr_matched"]["mean_rms_res"]
        / result["mpc"]["mean_rms_res"])
    return result


def main(argv=None, env=None) -> dict:
    """Run every D/r0 row; returns the report, writes it to the out.json
    argument when one is given, and prints it."""
    argv = sys.argv[1:] if argv is None else list(argv)
    env = os.environ if env is None else env
    res = int(argv[0]) if argv else 128
    out_path = argv[1] if len(argv) > 1 else None
    d_grid = [float(d) for d in env.get("CVM_DR0", "5,10").split(",")]
    n_steps = int(env.get("CVM_STEPS", "500"))
    dev = torch.device(env.get("CVM_DEVICE", "cuda"))
    torch.empty(0, device=dev)          # no such device: raises here
    report = {"resolution": res, "n_steps": n_steps,
              "device": (profiling.card() if dev.type == "cuda" else "cpu"),
              "rows": {}}
    for d in d_grid:
        r = row(row_cfg(res, d, n_steps), dev)
        report["rows"][f"d_over_r0={d:g}"] = r
        print(json.dumps({f"d={d:g}": r}), file=sys.stderr, flush=True)
    if out_path:
        with open(out_path, "w") as f:
            json.dump(report, f, indent=2)
            f.write("\n")
    print(json.dumps(report, indent=2))
    return report


if __name__ == "__main__":
    main()
