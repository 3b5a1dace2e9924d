"""The port's classical-vs-MPC benchmark
(benchmarks/classical_vs_mpc.py) on the CPU at a cut configuration: its
row function against the JAX package's SH + TSVD integrator on the same
turbulence window, and the report's schema against the JAX script's
(CLASSICAL_r05.json).

The window comes from the same integer-seeded host screens, so the ideal
integrator rows (no noise) are held to the JAX integrator.closed_loop's
settled residual RMS within rtol 1e-4 at every gain; the MPC half is the
port's closed loop (held to the JAX package in tests/test_torch_loop.py),
here checked for lock.
"""

import dataclasses
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_sensorlessao_tpu.models import integrator as jintegrator
from mpc_sensorlessao_tpu.models import wfs as jwfs
from mpc_sensorlessao_tpu.ops import phase_screens as jps
from mpc_sensorlessao_tpu.ops import zernike as jz
from mpc_sensorlessao_tpu.utils import config as jconfig
from mpc_sensorlessao_tpu_torch import reference_config
from mpc_sensorlessao_tpu_torch.benchmarks import classical_vs_mpc as cvm

torch.set_num_threads(1)
R, STEPS = 64, 16
JAX_REPORT = Path(__file__).resolve().parents[1] / "CLASSICAL_r05.json"


def cut_cfg(d: float):
    cfg = cvm.row_cfg(R, d, STEPS)
    return cfg.replace(sim=dataclasses.replace(cfg.sim, n_train=300,
                                               n_valid=50))


@pytest.fixture(scope="module")
def row5():
    return cvm.row(cut_cfg(5.0), "cpu")


def jax_window(cfg):
    """The JAX script's window (classical_vs_mpc.py:117-126) and its SH /
    vault / stack on the JAX package."""
    jcfg = jconfig.reference_config(resolution=R)
    tel = dataclasses.replace(jcfg.telescope, resolution=R)
    layers = jps.make_layers(int(cfg.sim.seed), jcfg.atmosphere, tel)
    basis = jz.make_basis(cfg.zernike.radial_order, R)
    npx = float(np.asarray(basis.mask).sum())
    start = cfg.sim.n_train + cfg.sim.n_valid
    phis = [jz.piston_removed_phase_masked(
        jps.phase_at(layers, jnp.float32(start + i), R), basis.mask, npx)
        * cfg.sim.magnification for i in range(STEPS)]
    sh = jwfs.build(R, n_lenslet=8)
    stack = basis.stack[1:]
    vault = jintegrator.calibration_vault(
        jwfs.interaction_matrix(sh, stack), cond=100.0)
    return (jnp.stack(phis).reshape(STEPS, -1), sh, stack.reshape(
        stack.shape[0], -1), vault, basis.mask.reshape(-1))


def test_ideal_integrator_rows_match_jax(row5):
    """Every gain's settled residual RMS of the noiseless row equals the
    JAX integrator's on the same window (rtol 1e-4), and the best gain is
    the one the row reports."""
    flat, sh, stack, vault, mask = jax_window(cut_cfg(5.0))
    want = []
    for gain in cvm.GAINS:
        _, rms = jintegrator.closed_loop(
            sh.slope_op, vault, stack, flat,
            jintegrator.IntegratorConfig(gain=gain), mask_flat=mask)
        want.append(float(np.asarray(rms)[STEPS // 2:].mean()))
    got = [r["mean_rms_res"] for r in row5["runs"]["integrator"]]
    assert [r["gain"] for r in row5["runs"]["integrator"]] == list(cvm.GAINS)
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert row5["integrator"]["gain"] == cvm.GAINS[int(np.argmin(want))]


def test_window_matches_jax():
    """The chunked per-step window of the port against the JAX script's
    (piston removed, magnified): the batched gather blends with tensor
    weights (1 ulp a layer, tests/test_torch_ops.py) and the in-pupil mean
    sums in another order, so 1e-5 of the window's peak."""
    from mpc_sensorlessao_tpu_torch.models import pipeline
    cfg = cut_cfg(5.0)
    system = pipeline.build(cfg, "cpu")
    got = cvm.turbulence_window(system, cfg, STEPS).numpy()
    want = np.asarray(jax_window(cfg)[0])
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def test_row_schema_and_quality(row5):
    """The row carries every key of the JAX script's row; the MPC loop
    locks (settled exact Strehl > 0.9), the noise-matched row is worse
    than the ideal one at each gain, and B1 launched nowhere on the CPU
    (the wrappers take their plain versions there)."""
    ref = json.loads(JAX_REPORT.read_text())["rows"]["d_over_r0=5"]
    for key, val in ref.items():
        assert key in row5, key
        if isinstance(val, dict):
            assert set(val) <= set(row5[key]), key
    assert row5["mpc"]["strehl_exact"] > 0.9
    assert row5["mpc"]["b1_launches"] == 0 == row5["b1_launches_build"]
    for ideal, noisy in zip(row5["runs"]["integrator"],
                            row5["runs"]["integrator_snr_matched"]):
        assert noisy["mean_rms_res"] > ideal["mean_rms_res"]
    assert row5["mpc_advantage_rms"] == pytest.approx(
        row5["integrator"]["mean_rms_res"] / row5["mpc"]["mean_rms_res"])
    assert row5["mean_rms_turb"] > row5["mpc"]["mean_rms_res"]


def test_strong_recipe_row_cfg():
    """From D/r0 = 10 the row takes config.strong_turbulence (the JAX
    script's :72-78), below it the reference recipe."""
    strong = cvm.row_cfg(R, 10.0, 7)
    assert strong.zernike.radial_order == 10
    assert strong.estimator.method == "mmse"
    assert strong.estimator.prior_scale == pytest.approx(0.05)
    assert (strong.mpc.warm_start, strong.mpc.var_ridge,
            strong.mpc.r_weight) == (True, 1e-2, 30.0)
    assert (strong.sim.d_over_r0, strong.sim.n_test) == (10.0, 7)
    weak = cvm.row_cfg(R, 5.0, 7)
    ref = reference_config(resolution=R)
    assert (weak.zernike, weak.mpc, weak.estimator) == (
        ref.zernike, ref.mpc, ref.estimator)


def test_main_writes_only_the_named_file(tmp_path, capsys, monkeypatch):
    """main() on "cpu": the report's schema, printed and written to the
    path given, nothing written without one."""
    monkeypatch.chdir(tmp_path)
    env = {"CVM_DR0": "5", "CVM_STEPS": "4", "CVM_DEVICE": "cpu"}
    out = tmp_path / "out.json"
    rep = cvm.main([str(32), str(out)], env)
    assert json.loads(out.read_text()) == json.loads(json.dumps(rep))
    printed = json.loads(capsys.readouterr().out)
    assert set(printed) == {"resolution", "n_steps", "device", "rows"}
    assert printed["device"] == "cpu" and printed["n_steps"] == 4
    assert list(printed["rows"]) == ["d_over_r0=5"]
    cvm.main(["32"], env)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["out.json"]
