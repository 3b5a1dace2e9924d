"""The port's closed-loop demos against the JAX demos on the CPU, at a
reduced size (R=64 as in the JAX demos, 40 test steps, the horizon sweep
over N = 2 and 8).

The turbulence is the same numpy-seeded window in both packages, so its
RMS is held at rtol 1e-4; the estimator's measurement noise comes from a
torch generator seeded 1 in place of the JAX PRNGKey(1) stream, so the
loop's settled numbers are held statistically: exact Strehl within 0.005,
residual RMS and rejection within 5%.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from mpc_sensorlessao_tpu.models import pipeline as jpipeline
from mpc_sensorlessao_tpu.utils import config as jconfig
from mpc_sensorlessao_tpu.utils import metrics as jmetrics
from mpc_sensorlessao_tpu_torch.examples import closed_loop_demo
from mpc_sensorlessao_tpu_torch.examples import horizon_sweep_demo

torch.set_num_threads(1)
N_TEST = 40


def test_closed_loop_demo_matches_the_jax_demo():
    got = closed_loop_demo.main("cpu", 64, 5.0, N_TEST)
    cfg = jconfig.reference_config(resolution=64)
    cfg = cfg.replace(sim=dataclasses.replace(
        cfg.sim, n_train=300, n_valid=50, n_test=N_TEST, d_over_r0=5.0))
    system = jpipeline.build(cfg, jax.random.PRNGKey(0))
    want = jmetrics.to_dict(jmetrics.summarize(jpipeline.run_closed_loop(
        system, cfg, jax.random.PRNGKey(1))))
    assert got.keys() == want.keys()
    assert got["mean_rms_turb"] == pytest.approx(want["mean_rms_turb"],
                                                 rel=1e-4)
    assert abs(got["mean_strehl_exact"] - want["mean_strehl_exact"]) < 0.005
    for key in ("mean_rms_res", "rejection"):
        assert got[key] == pytest.approx(want[key], rel=0.05), key


def test_horizon_sweep_demo_matches_the_jax_demo(tmp_path):
    horizons = (2, 8)
    png = tmp_path / "telemetry.png"
    got = horizon_sweep_demo.main("cpu", 64, 6, horizons, N_TEST,
                                  save=str(png))
    assert png.stat().st_size > 0
    cfg = jconfig.reference_config(resolution=64)
    cfg = cfg.replace(
        zernike=dataclasses.replace(cfg.zernike, radial_order=6),
        mpc=dataclasses.replace(cfg.mpc, var_ridge=1e-2,
                                var_max_radius=0.85, warm_start=True,
                                r_weight=30.0),
        sim=dataclasses.replace(cfg.sim, n_train=300, n_valid=50,
                                n_test=N_TEST))
    system = jpipeline.build(cfg, jax.random.PRNGKey(0))
    for N in horizons:
        cfg_n = cfg.replace(mpc=dataclasses.replace(cfg.mpc, horizon=N))
        out = jpipeline.run_closed_loop(jpipeline.with_horizon(system, cfg_n),
                                        cfg_n, jax.random.PRNGKey(1))
        s = horizon_sweep_demo.SETTLE
        res = float(np.asarray(out.rms_res)[s:].mean())
        turb = float(np.asarray(out.rms_turb)[s:].mean())
        strehl = float(np.asarray(out.strehl_exact)[s:].mean())
        assert abs(got[N]["strehl"] - strehl) < 0.005
        assert got[N]["rms_res"] == pytest.approx(res, rel=0.05)
        assert got[N]["rejection"] == pytest.approx(turb / res, rel=0.05)
