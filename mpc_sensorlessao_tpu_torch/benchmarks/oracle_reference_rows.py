"""The reference rows through the independent float64 NumPy oracle (port
of the repository's ``benchmarks/oracle_reference_rows.py``).

``RESULTS_r05.json``'s reference rows collapse at D/r0 >= 10 (the loop
injects aberration) while the tuned rows hold.  Is that the physics of
the reference's plain-LS estimator operated outside its linear capture
range, or an engine bug?  This runs the independent float64 NumPy oracle
(``_oracle_numpy``, the port's copy of ``tests/oracle_numpy.py``: a
naive re-transcription of the reference loop, README.md:444-626,
sharing no code with either engine) in the exact reference
configuration -- 28 modes, plain LS, cold start, SNR-10 dB noise at the
reference's injection point, mag_conv scaling (README.md:277-284) --
on the operators of the port's own build, and records whether the
collapse reproduces.  The build runs on ORACLE_DEVICE (its VAR model in
float64, the loop operators rounded to float32, as the loop uses them);
the oracle runs on the host in float64 and needs no card.

Usage: python -m mpc_sensorlessao_tpu_torch.benchmarks.oracle_reference_rows
       [out.json]
Env:   ORACLE_RES=512     pupil grid (default 512 = flagship protocol)
       ORACLE_STEPS=120   closed-loop steps
       ORACLE_TRAIN=1000  train split (with n_valid=500 at default, else 50)
       ORACLE_DR0=5,10    D/r0 grid
       ORACLE_DEVICE=cuda the build's device (the card unless "cpu" is
                          named)
The report is printed, and written only to the out.json given.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import time

import numpy as np

from ..models import pipeline
from ..utils.config import SystemConfig, mag_conv, reference_config
from . import _protocol as P
from ._oracle_numpy import closed_loop as oracle_loop
from ._oracle_numpy import pupil_phase


def oracle_cfg(res: int, n_train: int) -> SystemConfig:
    """reference_config(res); a ``n_train`` other than the default's
    gives the n_train / 50 split (oracle_reference_rows.py:67-70)."""
    cfg = reference_config(resolution=res)
    if n_train != cfg.sim.n_train:
        cfg = cfg.replace(sim=dataclasses.replace(
            cfg.sim, n_train=n_train, n_valid=50))
    return cfg


def oracle_params(cfg: SystemConfig, system: pipeline.System) -> dict:
    """The oracle's parameters from a build of the port, in float64 (the
    counterpart of tests/test_golden_trajectory.py's _oracle_params)."""
    est = system.est
    q = cfg.mpc.q_weight
    nx, n_act = system.dm_model.influence.shape
    R_ = system.basis.mask.shape[0]
    f64 = P.host
    return {
        # strip the engine's wrap-padding: the oracle wraps by itself
        "screens": f64(system.layers.screens)[:, : -(R_ + 1), : -(R_ + 1)],
        "step_px": f64(system.layers.step_px),
        "start": float(cfg.sim.n_train + cfg.sim.n_valid),
        "mag": cfg.sim.magnification,
        "mask": system.basis.mask.cpu().numpy(),
        "pupil": f64(est.pupil),
        "div_phases": f64(est.diversity_phases),
        "crop_half": est.crop_half,
        "scale": est.scale,
        "A_s": f64(est.A_s),
        "b_s": f64(est.b_s),
        "solve_op": f64(est.solve_op),
        "influence": f64(system.dm_model.influence),
        "state_stack": f64(system.basis.stack[1:]),
        "M1": f64(system.mats.M1),
        "M2": f64(system.mats.M2),
        "B_conv": f64(system.mats.B_conv),
        "Q_tilda": f64(system.mats.Q_tilda),
        "closed_form": f64(system.mats.closed_form),
        "A1": f64(system.var_model.coefficient(1)),
        "A2": f64(system.var_model.coefficient(2)),
        "Q": q * np.eye(nx),
        "R": np.eye(n_act),
        "Qf": q * np.eye(nx),
        "u_max": cfg.mpc.u_max,
        "barrier_k": cfg.mpc.barrier_k,
        "newton_steps": cfg.mpc.newton_steps,
        "horizon": cfg.mpc.horizon,
    }


def turb_rms(params: dict, n_steps: int, mag: float) -> np.ndarray:
    """Per-step turbulence RMS in the pupil (the rejection's numerator;
    the oracle returns the residual RMS only)."""
    vals = []
    R = params["mask"].shape[0]
    for k in range(n_steps):
        ph = pupil_phase(params["screens"], params["step_px"],
                         params["start"] + k, R, params["mask"], mag)
        inside = ph[params["mask"]]
        vals.append(np.sqrt(np.mean((inside - inside.mean()) ** 2)))
    return np.asarray(vals)


def row(cfg: SystemConfig, params: dict, d: float, gn: int, n_steps: int,
        rms_t: np.ndarray, noise_std: float, n_pixels: int) -> dict:
    """One (D/r0, Gauss-Newton) row: the oracle loop on the noise of
    np.random.default_rng(11), its settled (last half) statistics."""
    rng = np.random.default_rng(11)
    noise = noise_std * rng.standard_normal((n_steps, n_pixels))
    t0 = time.time()
    _, rms_res = oracle_loop(
        dict(params, mag=mag_conv(d)), n_steps, noise, solver="fastmpc",
        cold_start=cfg.mpc.cold_start, gauss_newton_iters=gn)
    s = n_steps // 2
    return {
        "mean_rms_res_rad": round(float(rms_res[s:].mean()), 4),
        "p95_rms_res_rad": round(float(np.percentile(rms_res[s:], 95)), 4),
        "mean_rms_turb_rad": round(float(rms_t[s:].mean()), 4),
        "rejection": round(float(rms_t[s:].mean() / rms_res[s:].mean()), 3),
        "mean_strehl_marechal": round(
            float(np.exp(-(rms_res[s:] ** 2)).mean()), 4),
        "collapsed": bool(rms_res[s:].mean() > rms_t[s:].mean()),
        "oracle_s": round(time.time() - t0, 1),
    }


def main(argv=None, env=None) -> dict:
    """Build, run every row; returns the report, prints it, and writes it
    to the out.json argument when one is given."""
    argv = sys.argv[1:] if argv is None else list(argv)
    env = os.environ if env is None else env
    out_path = argv[0] if argv else None
    dev = P.device(env, "ORACLE_DEVICE")
    res = int(env.get("ORACLE_RES", "512"))
    n_steps = int(env.get("ORACLE_STEPS", "120"))
    n_train = int(env.get("ORACLE_TRAIN", "1000"))
    d_grid = [float(d) for d in env.get("ORACLE_DR0", "5,10").split(",")]

    cfg = oracle_cfg(res, n_train)
    t0 = time.time()
    system = pipeline.build(cfg, dev)
    P.sync(dev)
    build_s = time.time() - t0
    params = oracle_params(cfg, system)
    std = float(system.est.noise_std)
    report = {
        "what": ("Independent float64 NumPy oracle (the port's copy of "
                 "tests/oracle_numpy.py) run in the exact reference "
                 "configuration -- 28 modes, plain LS estimator, cold "
                 "start, SNR-10dB noise -- on the port's build, to check "
                 "whether the RESULTS reference_rows collapse at D/r0>=10 "
                 "is reference physics or an engine bug"),
        "resolution": res, "n_steps": n_steps,
        "n_train": cfg.sim.n_train, "n_valid": cfg.sim.n_valid,
        "noise_std": std, "build_s": round(build_s, 1),
        "device": P.device_name(dev),
        "rows": {},
    }
    for d in d_grid:
        rms_t = turb_rms(params, n_steps, mag_conv(d))
        for gn in (0, 1):
            r = row(cfg, params, d, gn, n_steps, rms_t, std,
                    system.est.n_pixels)
            report["rows"][f"d_over_r0={d:g}_gn={gn}"] = r
            print(json.dumps({f"d={d:g} gn={gn}": r}), file=sys.stderr,
                  flush=True)
    P.save_report(report, out_path)
    print(json.dumps(report, indent=2))
    return report


if __name__ == "__main__":
    main()
