"""The port's demos (mpc_sensorlessao_tpu_torch/examples/) against the
JAX demos (examples/) on the CPU.

wfs_demo and mcao_demo are held to the JAX demos' numbers recorded at
full precision in mpc_sensorlessao_tpu_torch/examples/demo_reference.json
(written by tests/torch_demo_support.py): host float64 analytics (MCAO
variances, tomography error and Strehl) rtol 1e-6, the 60-screen
Monte-Carlo residual (numpy-seeded screens, float32 projection and fits)
rtol 1e-3, the geometric slope signal rtol 1e-5; the slopes-MMSE map RMS
within 1% (a float32 CG at tol 5e-2 is not reproducible to rounding:
relative perturbations of 1e-7 of the demo's slopes move the RMS by up to
0.77%; a model with its x-y cross covariance dropped moves it by 11%,
test_wfs_demo_rms_limit_rejects_a_broken_model); the camera
chain's slope error, whose photon and readout noise come from another
generator, within 25%.  turbulence_demo (numpy screens, host analytics)
against the JAX package's functions at rtol 1e-10, at 8 screens.
"""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from mpc_sensorlessao_tpu.ops import phase_screens as jps
from mpc_sensorlessao_tpu.ops import phase_stats as jstats
from mpc_sensorlessao_tpu.ops import zernike_stats as jzs
from mpc_sensorlessao_tpu.utils import config as jconfig
from mpc_sensorlessao_tpu_torch.examples import mcao_demo, turbulence_demo
from mpc_sensorlessao_tpu_torch.examples import wfs_demo
from mpc_sensorlessao_tpu_torch.models import slopes_mmse, wfs
from mpc_sensorlessao_tpu_torch.ops import phase_screens
from mpc_sensorlessao_tpu_torch.utils import config
import torch_demo_support

torch.set_num_threads(1)

MMSE_RMS_RTOL = 0.01


@pytest.fixture(scope="module")
def reference():
    return json.loads(torch_demo_support.REFERENCE.read_text())


def test_wfs_demo_matches_the_jax_demo(reference):
    want = reference["wfs"]
    got = wfs_demo.main("cpu")
    for key in ("tomography_error_rad2", "tomography_strehl"):
        assert got[key] == pytest.approx(want[key], rel=1e-6), key
    assert got["slope_signal"] == pytest.approx(want["slope_signal"],
                                                rel=1e-5)
    assert got["mmse_rms"] == pytest.approx(want["mmse_rms"],
                                            rel=MMSE_RMS_RTOL)
    assert got["camera_slope_error"] == pytest.approx(
        want["camera_slope_error"], rel=0.25)


@pytest.mark.parametrize("control", ["no-cross-term", "cxx-x1.1"])
def test_wfs_demo_rms_limit_rejects_a_broken_model(reference, control):
    """The demo's slopes-MMSE problem through a broken model: the x-y
    cross covariance dropped (+11% of the RMS) or the slope covariances
    10% too large (-9%) leave the map RMS outside MMSE_RMS_RTOL of the
    JAX record, so that limit tells a wrong reconstructor from rounding."""
    atm = config.AtmosphereConfig(fractional_r0=(1.0,), altitudes=(0.0,),
                                  wind_speeds=(5.0,), wind_directions=(0.0,))
    tel = config.TelescopeConfig(resolution=wfs_demo.R)
    sh = wfs.build(wfs_demo.R, n_lenslet=wfs_demo.NL, device="cpu")
    scr = phase_screens.synthesize_screen(
        7, atm, wfs_demo.R, tel.pixel_pitch)[:wfs_demo.R, :wfs_demo.R] * 0.3
    geo = wfs.geometric_slopes(sh, torch.as_tensor(
        np.asarray(scr - scr.mean(), dtype=np.float32)))
    model = slopes_mmse.build(atm, tel.diameter, wfs_demo.NL, sh.valid,
                              (0.02 / tel.pixel_pitch) ** 2, device="cpu")
    sound = slopes_mmse.reconstruct(model, geo, tel.pixel_pitch)
    ops = {k: getattr(model, k) for k in ("cxx", "cyy", "cxy")}
    if control == "no-cross-term":
        ops = {"cxy": dataclasses.replace(
            ops["cxy"], spec=torch.zeros_like(ops["cxy"].spec))}
    else:
        ops = {k: dataclasses.replace(op, spec=op.spec * 1.1)
               for k, op in ops.items()}
    broken = slopes_mmse.reconstruct(dataclasses.replace(model, **ops), geo,
                                     tel.pixel_pitch)
    want = reference["wfs"]["mmse_rms"]
    assert float(sound.std(correction=0)) == pytest.approx(
        want, rel=MMSE_RMS_RTOL)
    assert abs(float(broken.std(correction=0)) / want - 1) > MMSE_RMS_RTOL


def test_mcao_demo_matches_the_jax_demo(reference):
    want = reference["mcao"]
    got = mcao_demo.main("cpu")
    for key in ("piston_free_var_rad2", "scao_var_rad2"):
        assert got[key] == pytest.approx(want[key], rel=1e-6), key
    for dm in ("one_dm", "two_dm"):
        assert got[dm]["mcao_var_rad2"] == pytest.approx(
            want[dm]["mcao_var_rad2"], rel=1e-6)
        np.testing.assert_allclose(got[dm]["target_vars_rad2"],
                                   want[dm]["target_vars_rad2"], rtol=1e-6)
    np.testing.assert_allclose(got["predicted_rad2"], want["predicted_rad2"],
                               rtol=1e-6)
    np.testing.assert_allclose(got["monte_carlo_rad2"],
                               want["monte_carlo_rad2"], rtol=1e-3)


def test_turbulence_demo_matches_the_jax_functions():
    n = 8
    got = turbulence_demo.main(n_screens=n)
    atm = jconfig.AtmosphereConfig(fractional_r0=(1.0,), altitudes=(0.0,),
                                   wind_speeds=(5.0,), wind_directions=(0.0,))
    tel = jconfig.TelescopeConfig(resolution=64)
    pitch = tel.pixel_pitch
    scr = [np.asarray(jps.synthesize_screen(s, atm, 64, pitch))[:64, :64]
           for s in range(n)]
    for dpx, row in got["structure_function"].items():
        emp = np.zeros(1)           # the demo's float64 accumulator
        for x in scr:
            emp += np.mean((x[:, dpx:] - x[:, :-dpx]) ** 2) / n
        emp = float(emp[0])
        assert row["empirical"] == pytest.approx(emp, rel=1e-10)
        assert row["analytic"] == pytest.approx(
            float(jstats.structure_function(dpx * pitch, atm)), rel=1e-10)
    atm_k = jconfig.AtmosphereConfig(r0=1.0, L0=1e6, fractional_r0=(1.0,),
                                     altitudes=(0.0,), wind_speeds=(5.0,),
                                     wind_directions=(0.0,))
    for j, v in got["residual_variance"].items():
        assert v == pytest.approx(jzs.residual_variance(j, atm_k, 1.0),
                                  rel=1e-10)
    assert got["tip_tilt_arcsec"] == pytest.approx(float(jzs.rms_arcsec(
        atm, 1.0, jzs.variance_analytic(atm, 1.0, 1)[1])), rel=1e-10)
