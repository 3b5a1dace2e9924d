"""Helpers shared by the port's experiment protocols (protocol_sweep,
protocol_edge, excursion_tail, modes_horizon, montecarlo_sweep,
full_protocol, latency_b1): one copy of what each of the repository's
protocol scripts repeats.

* ``settled_row``  the settled-tail row with its crop-validity flag
  (benchmarks/protocol_sweep.py:60-91, protocol_edge.py:65-93);
* ``tail_row``     the excursion-tail row (excursion_tail.py:44-70);
* ``modes_row``    the batched mode-sweep row (modes_horizon.py:60-77);
* ``mc_cells``     the per-SNR Monte-Carlo cells with the divergence rule
  ``rms <= 10 x turbulence`` (montecarlo_sweep.py:98-115);
* ``var_validation``  the held-out VAR RMSE/RRMSE
  (protocol_sweep.py:94-101);
* ``protocol_cfg`` / ``tuned_cfg``  the protocol's split and the tuned
  recipe (order, ridge VAR, mmse prior, warm start, r_weight 30);
* ``load_report`` / ``save_report``  the staged-JSON merge and save
  (protocol_sweep.py:129-140): a report is written only to a path the
  caller names, and a prior one is resumed only where
  ``resume_mismatch`` finds nothing (the same device and knobs), and
  then only its row sections;
* ``times_ms`` / ``host_times_ms``  a run's ms on the card's clock
  (profiling.cuda_times_ms: CUDA events) and on the host clock after a
  device synchronize -- the two clocks of every port timer.

Each row keeps the JAX script's keys and rounding; the numbers are
computed in host float64 numpy from the run's float32 outputs, as the
JAX scripts compute them.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import time

import numpy as np
import torch

from ..models import var
from ..parallel import montecarlo
from ..utils import profiling
from ..utils.config import SystemConfig, reference_config, strong_turbulence

def host(x) -> np.ndarray:
    """A float64 numpy copy of a tensor (or array)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
    return np.asarray(x, dtype=np.float64)


def env_int(env, name: str) -> int | None:
    """The integer env knob ``name``, or None when it is unset or empty."""
    return int(env[name]) if env.get(name) else None


def device(env, name: str) -> torch.device:
    """The device the env knob ``name`` names (default the card); raises
    here when there is no such device, rather than falling back."""
    dev = torch.device(env.get(name, "cuda"))
    torch.empty(0, device=dev)
    return dev


def sync(dev: torch.device) -> None:
    """Wait for the device's queued work (a no-op on the CPU)."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def times_ms(fn, dev: torch.device, repeats: int) -> list:
    """The ms of each of ``repeats`` runs of ``fn`` after one warm-up run:
    CUDA events around each run on the card (profiling.cuda_times_ms),
    the host clock on the CPU (no device time exists there)."""
    if dev.type == "cuda":
        return profiling.cuda_times_ms(fn, 1, repeats)
    fn()
    return host_times_ms(fn, dev, repeats)


def host_times_ms(fn, dev: torch.device, repeats: int) -> list:
    """The ms of each of ``repeats`` runs of ``fn`` on the host clock,
    each ended by a device synchronize (call it after a warm-up run)."""
    out = []
    for _ in range(repeats):
        sync(dev)
        t0 = time.perf_counter()
        fn()
        sync(dev)
        out.append(1e3 * (time.perf_counter() - t0))
    return out


def generator(dev: torch.device, seed: int) -> torch.Generator:
    """A torch generator on ``dev`` seeded ``seed``."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return gen


def device_name(dev: torch.device) -> str:
    """The card's name and power limit (nvidia-smi), or "cpu"."""
    return profiling.card() if dev.type == "cuda" else "cpu"


def shared_scenarios(cfg: SystemConfig, mag, noise_scale, noise_seed: int,
                     dev) -> montecarlo.ScenarioBatch:
    """Scenarios on the shared test window (step n_train + n_valid), each
    with its magnification and noise scale (equal-length sequences), the
    batch's measurement noise from ``noise_seed``."""
    f32 = dict(dtype=torch.float32, device=dev)
    mag = torch.as_tensor(mag, **f32)
    return montecarlo.ScenarioBatch(
        start_step=torch.full_like(
            mag, float(cfg.sim.n_train + cfg.sim.n_valid)),
        mag=mag, noise_scale=torch.as_tensor(noise_scale, **f32),
        noise_seed=noise_seed)


def settled_row(out, i: int | None = None) -> dict:
    """Per-scenario settled-tail summary (last half of the time axis) of
    scenario ``i`` of a batched run, or of a single-scenario run."""
    def arr(x):
        a = host(x)
        return a[i] if i is not None else a
    res = arr(out.rms_res)
    s = res.shape[-1] // 2
    turb = arr(out.rms_turb)[s:]
    strehl_x = arr(out.strehl_exact)[s:]
    strehl_m = arr(out.strehl)[s:]
    res = res[s:]
    row = {
        "mean_rms_res_rad": round(float(res.mean()), 4),
        "p95_rms_res_rad": round(float(np.percentile(res, 95)), 4),
        "mean_rms_turb_rad": round(float(turb.mean()), 4),
        "rejection": round(float(turb.mean() / res.mean()), 3),
        "mean_strehl": round(float(strehl_x.mean()), 4),
        "min_strehl": round(float(strehl_x.min()), 4),
        "mean_strehl_marechal": round(float(strehl_m.mean()), 4),
        "finite": bool(np.isfinite(res).all()),
    }
    # the exact OTF-volume Strehl holds only while the residual PSF peak
    # stays inside the diversity crop; an unlocked row (rejection ~< 1)
    # pushes it outside and strehl_exact understates: flag the row
    if row["rejection"] < 1.2 or row["mean_strehl"] < 0.1:
        row["strehl_exact_crop_valid"] = False
    return row


def tail_row(out) -> dict:
    """Excursion-tail statistics of a single-scenario run's settled half:
    mean / min / p5 exact Strehl, residual mean / p95 / max, the share of
    steps under Strehl 0.5 and the longest run of them."""
    res = host(out.rms_res)
    s = res.shape[-1] // 2
    res_t = res[s:]
    strehl = host(out.strehl_exact)[s:]
    turb = host(out.rms_turb)[s:]
    below = strehl < 0.5
    runs, cur = [], 0
    for b in below:
        cur = cur + 1 if b else 0
        runs.append(cur)
    return {
        "mean_strehl": round(float(strehl.mean()), 4),
        "min_strehl": round(float(strehl.min()), 4),
        "p5_strehl": round(float(np.percentile(strehl, 5)), 4),
        "mean_rms_res_rad": round(float(res_t.mean()), 4),
        "p95_rms_res_rad": round(float(np.percentile(res_t, 95)), 4),
        "max_rms_res_rad": round(float(res_t.max()), 4),
        "rejection": round(float(turb.mean() / res_t.mean()), 3),
        "frac_steps_strehl_below_0.5": round(float(below.mean()), 4),
        "longest_excursion_steps": int(max(runs) if runs else 0),
        "finite": bool(np.isfinite(res_t).all()),
    }


def modes_row(out, t_loop: float, batch: int, n_steps: int) -> dict:
    """Settled summary of a batched run over the whole batch, with its
    loop seconds, solves/s and the multiple of real time (200 Hz)."""
    res = host(out.rms_res)
    turb = host(out.rms_turb)
    sx = host(out.strehl_exact)
    s = res.shape[-1] // 2
    res_t, turb_t, sx_t = res[..., s:], turb[..., s:], sx[..., s:]
    return {
        "mean_rms_res_rad": round(float(res_t.mean()), 4),
        "mean_rms_turb_rad": round(float(turb_t.mean()), 4),
        "rejection": round(float(turb_t.mean() / res_t.mean()), 3),
        "mean_strehl": round(float(sx_t.mean()), 4),
        "min_strehl": round(float(sx_t.min()), 4),
        "finite": bool(np.isfinite(res).all()),
        "loop_s": round(t_loop, 2),
        "solves_per_s": round(batch * n_steps / t_loop, 1),
        "x_real_time": round(batch * n_steps / t_loop / 200.0, 1),
    }


def mc_cells(out, d: float, snr_grid, reps: int) -> dict:
    """Per-SNR cells of a (len(snr_grid) * reps)-scenario run (scenario
    i * reps + r: SNR i, repetition r): over the kept scenarios -- finite,
    with a settled residual at most 10x the turbulence -- the mean and
    p10 settled exact Strehl, the residual's mean and spread, and the
    diverged count."""
    n_steps = out.rms_res.shape[-1]
    res_m = host(out.rms_res)[:, n_steps // 2:]
    turb_m = host(out.rms_turb)[:, n_steps // 2:]
    sx = host(out.strehl_exact)[:, n_steps // 2:]
    cells = {}
    for i, snr in enumerate(snr_grid):
        sl = slice(i * reps, (i + 1) * reps)
        rm = res_m[sl].mean(axis=1)
        ok = np.isfinite(rm) & (rm <= 10.0 * turb_m[sl].mean(axis=1))
        cells[f"d={d:g},snr={snr:g}dB"] = {
            "mean_strehl": round(float(sx[sl][ok].mean()), 4),
            "p10_strehl": round(
                float(np.percentile(sx[sl][ok].mean(axis=1), 10)), 4),
            "mean_rms_res": round(float(rm[ok].mean()), 4),
            "std_rms_res": round(float(rm[ok].std()), 4),
            "n_diverged": int((~ok).sum()),
        }
    return cells


def var_validation(cfg: SystemConfig, system,
                   digits: int | None = 5) -> dict:
    """Held-out VAR RMSE/RRMSE (README.md:134-155) of the build's float64
    VAR model over its validation window, rounded to ``digits`` (None:
    not rounded)."""
    states = system.coeff_series[:, 1:].double()
    _, rmse, rrmse = var.validate(
        system.var_model, states[cfg.sim.n_train - cfg.mpc.var_order:])
    return {k: round(float(torch.mean(v)), digits) if digits is not None
            else float(torch.mean(v))
            for k, v in (("var_rmse_mean", rmse), ("var_rrmse_mean", rrmse))}


def protocol_cfg(resolution: int, n_steps: int | None = None,
                 n_train: int | None = None, n_valid: int = 50,
                 flow: str = "periodic") -> SystemConfig:
    """reference_config(resolution) with ``n_steps`` closed-loop steps
    (None: the sim default, 500); a given ``n_train`` replaces the
    1000/500 split by n_train/n_valid; ``flow="conditional"`` runs the
    conditional-Gaussian flow."""
    cfg = reference_config(resolution=resolution)
    if flow != cfg.atmosphere.flow:
        cfg = cfg.replace(atmosphere=dataclasses.replace(cfg.atmosphere,
                                                         flow=flow))
    if n_train is not None:
        cfg = cfg.replace(sim=dataclasses.replace(
            cfg.sim, n_train=n_train, n_valid=n_valid))
    if n_steps is not None:
        cfg = cfg.replace(sim=dataclasses.replace(cfg.sim, n_test=n_steps))
    return cfg


def tuned_cfg(cfg: SystemConfig, d_over_r0: float, radial_order: int = 10,
              var_max_radius: float | None = None) -> SystemConfig:
    """``cfg`` (its split and steps kept) at D/r0 = ``d_over_r0`` with the
    tuned recipe (config.strong_turbulence: ridge VAR, mmse prior scale
    min(0.15, 0.5/d), warm start, r_weight 30) at ``radial_order``, and
    the VAR companion-radius clamp ``var_max_radius``."""
    t = strong_turbulence(cfg, d_over_r0)
    return t.replace(
        zernike=dataclasses.replace(t.zernike, radial_order=radial_order),
        mpc=dataclasses.replace(t.mpc, var_max_radius=var_max_radius))


def resume_mismatch(prior: dict, report: dict, knobs=(),
                    nested=None) -> list[str]:
    """What keeps ``prior``, an earlier report, from being resumed into
    the fresh ``report``: each knob whose value differs, as "name: prior
    != fresh".  The knobs are the device (the card's name and power
    limit, or "cpu") and ``knobs``, keys that both reports hold (the
    resolution, steps, train and valid sizes, repeats...); ``nested``
    maps (section, key) to the fresh run's value of a knob that a report
    records only inside that row section (a batch, say), checked where
    the prior holds the section.  Empty: the prior may be resumed."""
    diff = []
    for key in ("device", *knobs):
        if prior.get(key) != report.get(key):
            diff.append(f"{key}: {prior.get(key)!r} != {report.get(key)!r}")
    for (section, key), value in (nested or {}).items():
        if section in prior and prior[section].get(key) != value:
            diff.append(f"{section}.{key}: {prior[section].get(key)!r} != "
                        f"{value!r}")
    return diff


def load_report(out_path: str | None, report: dict, sections,
                knobs=("resolution", "n_steps"), nested=None) -> dict:
    """A staged run: when ``out_path`` holds an earlier report that
    ``resume_mismatch`` (device, ``knobs``, ``nested``) lets resume,
    merge its row ``sections`` -- the keys the script's stages write --
    into ``report``; the fresh run's metadata always stands.  A prior
    that does not match is named on stderr and not merged: the run
    starts afresh (and overwrites it).  Returns ``report``."""
    if not out_path or not os.path.exists(out_path):
        return report
    with open(out_path) as f:
        prior = json.load(f)
    diff = resume_mismatch(prior, report, knobs, nested)
    if diff:
        print(f"not resuming {out_path}: it was made with another "
              f"{'; '.join(diff)}; running afresh", file=sys.stderr)
        return report
    report.update({k: prior[k] for k in sections if k in prior})
    return report


def save_report(report: dict, out_path: str | None) -> None:
    """Write the report as indented JSON to ``out_path``, when given."""
    if not out_path:
        return
    with open(out_path, "w") as f:
        json.dump(report, f, indent=2)
        f.write("\n")
