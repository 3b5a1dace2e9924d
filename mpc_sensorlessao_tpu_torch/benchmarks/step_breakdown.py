"""Decomposition of the closed-loop control step on the card (port of the
repository's ``benchmarks/step_breakdown.py``).

Times each stage of the R=512 step on its own, over (B, ...) tensors in
a Python loop of ``steps`` iterations -- (1) turbulence window + residual
formation + pupil RMS, (2) the fused PSF measure (kernel B1) + noise,
(3) estimate + QP assembly + fixed-Newton solve + cost (with
``gauss_newton_iters`` > 0 through estimate_gauss_newton, which measures
once more a pass), (4) DM synthesis -- each iteration's carry perturbed
by 1e-12 x its sum, as the JAX script's scan carries it, so that every
iteration depends on the last.  Then the whole step
(montecarlo.run_batch(shared_window="verified")) for comparison, and
the sum of the parts.  Each figure is us a step per scenario: the median
of profiling.TIME_REPEATS runs after a warm-up, by CUDA events around
each ``steps``-long run on the card (profiling.cuda_times_ms), by the
host clock on the CPU.  ``device`` is the card's name and power limit.
TF32 stays off.

Usage: python -m mpc_sensorlessao_tpu_torch.benchmarks.step_breakdown
       [R] [B] [STEPS]
Env:   SB_DEVICE=cuda (the card unless "cpu" is named)
"""

from __future__ import annotations

import dataclasses
import json
import os
import statistics
import sys

import numpy as np
import torch

from ..models import closed_loop, estimator, mpc, pipeline
from ..ops import newton_kkt, phase_screens, zernike
from ..parallel import montecarlo
from ..utils import profiling
from ..utils.config import SystemConfig, reference_config
from . import _protocol as P


def step_cfg(R: int, steps: int) -> SystemConfig:
    """reference_config(R) with the 300 / 50 ID split and ``steps`` test
    steps (step_breakdown.py:70-72, step_knockouts.py:172-174)."""
    cfg = reference_config(resolution=R)
    return cfg.replace(sim=dataclasses.replace(
        cfg.sim, n_train=300, n_valid=50, n_test=steps))


def us_per_step(run, dev, steps: int, B: int) -> float:
    """us a step per scenario of ``run`` (``steps`` steps of B
    scenarios): the median of profiling.TIME_REPEATS timed runs."""
    ms = statistics.median(P.times_ms(run, dev, profiling.TIME_REPEATS))
    return 1e3 * ms / steps / B


def stages(system, cfg: SystemConfig, B: int, steps: int, dev) -> dict:
    """The four stage runs, by key: each a function running ``steps``
    iterations of its stage over B scenarios."""
    models, layers, est = system.loop, system.layers, system.loop.est
    R = cfg.resolution
    nx, nu = models.influence.shape
    N = cfg.mpc.horizon
    f32 = dict(dtype=torch.float32, device=dev)
    mags = torch.full((B,), float(cfg.sim.magnification), **f32)
    stack = models.state_stack.reshape(nx, R * R)

    # 1. turbulence window + piston removal + residual formation + rms
    #    (phase_cor carried per scenario, scalar-perturbed feedback)
    def turb():
        pc = torch.zeros((B, R, R), **f32)
        for idx in range(steps):
            raw = phase_screens.phase_at(layers, np.float32(1000 + idx), R)
            pt = zernike.piston_removed_phase_masked(
                raw, models.mask, models.mask_npix) * mags[:, None, None]
            pr = pt + pc
            s = torch.sum(closed_loop._pupil_rms(models, pr)
                          + closed_loop._pupil_rms(models, pt))
            pc = pc * (1.0 + 1e-12 * s)
        return pc

    # 2. fused PSF measure + noise (per scenario)
    ph0 = torch.as_tensor(
        np.random.default_rng(0).normal(size=(B, R, R)) * 0.2, **f32)
    gen = P.generator(dev, 7)

    def measure():
        ph = ph0
        for _ in range(steps):
            noise = estimator.sample_noise(est, gen, (B,))
            s = torch.sum(estimator.measure(est, ph, noise))
            ph = ph * (1.0 + 1e-12 * s)
        return ph

    # 3. estimate + QP assembly + fixed-Newton solve (per scenario); a
    #    Gauss-Newton pass re-runs the fused PSF measure
    gn = cfg.estimator.gauss_newton_iters
    y0 = torch.as_tensor(
        np.random.default_rng(1).normal(size=(B, est.n_pixels)) * 0.1,
        **f32) + est.b_s

    def ctrl():
        y = y0
        u1 = u2 = torch.zeros((B, nu), **f32)
        xp = torch.zeros((B, nx), **f32)
        for _ in range(steps):
            if gn > 0:
                x0 = estimator.estimate_gauss_newton(
                    est, y, models.state_stack, gn)
            else:
                x0 = estimator.estimate(est, y)
            bref = mpc.b_ref(models.mats, u1, u2)
            r, c, x_free = mpc.gradient_terms(models.mats, x0, xp, bref)
            state = newton_kkt.solve_fixed(
                models.prob, models.fixed_op, x0, xp, bref, horizon=N)
            U = state.U.reshape(B, N * nu)
            u = U[:, :nu]
            s = torch.sum(mpc.cost(models.mats, U, r, c)
                          + torch.linalg.vector_norm(mpc.predicted_states(
                              models.mats, U, x_free)[:, :nx], dim=-1))
            y, u1, u2, xp = y * (1.0 + 1e-12 * s), u, u1, x0
        return y

    # 4. DM modal synthesis (B, nu) -> (B, R, R)
    u0 = torch.as_tensor(
        np.random.default_rng(2).normal(size=(B, nu)) * 0.1, **f32)

    def synth():
        u = u0
        for _ in range(steps):
            ad = u @ models.influence.T                       # (B, nx)
            pc = (ad @ stack).reshape(B, R, R)
            u = u * (1.0 + 1e-12 * torch.sum(pc))
        return u

    return {"turb_residual_us": turb, "measure_us": measure,
            "estimate_qp_us": ctrl, "synthesis_us": synth}


def main(argv=None, env=None) -> dict:
    """Time the stages and the whole step; returns the report and prints
    it as one JSON line."""
    argv = sys.argv[1:] if argv is None else list(argv)
    env = os.environ if env is None else env
    dev = P.device(env, "SB_DEVICE")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    R = int(argv[0]) if len(argv) > 0 else 512
    B = int(argv[1]) if len(argv) > 1 else 256
    steps = int(argv[2]) if len(argv) > 2 else 25

    cfg = step_cfg(R, steps)
    system = pipeline.build(cfg, dev)
    out = {"R": R, "B": B, "steps": steps, "device": P.device_name(dev)}
    for key, run in stages(system, cfg, B, steps, dev).items():
        out[key] = round(us_per_step(run, dev, steps, B), 2)
        print(key, out[key], file=sys.stderr, flush=True)

    # 5. the real full step for comparison (shared-window bench path)
    scen = montecarlo.make_scenarios(
        cfg, torch.Generator().manual_seed(1), B,
        d_over_r0_grid=(5.0,), snr_db_grid=(10.0,), device=dev)
    montecarlo.assert_shared_window(scen)

    def full():
        return montecarlo.run_batch(system.loop, system.layers, cfg, scen,
                                    n_steps=steps, shared_window="verified")

    out["full_step_us"] = round(us_per_step(full, dev, steps, B), 2)
    out["sum_of_parts_us"] = round(
        out["turb_residual_us"] + out["measure_us"]
        + out["estimate_qp_us"] + out["synthesis_us"], 2)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
