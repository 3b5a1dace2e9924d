"""PyTorch port vs the JAX package: the relay projection, modal
tomography, modal MCAO and the spectral Zernike analytics.

The same numpy-seeded inputs go through the JAX function and its port.
Tolerances: host numpy float64 analytics (zernike_stats, the tomography
and MCAO builds' variances and projections) rtol 1e-10; float32 device
products (relay projections, the tomography and MCAO gains and their
batched application) rtol 1e-4 or atol 1e-5 of the peak.  Sizes as in
tests/test_relay.py, test_tomography.py, test_mcao.py and
test_zernike_stats.py, with orders cut to 2-3 where the JAX reference's
quadrature dominates the time.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_sensorlessao_tpu.models import mcao as jmcao
from mpc_sensorlessao_tpu.models import tomography as jtomo
from mpc_sensorlessao_tpu.ops import phase_screens as jps
from mpc_sensorlessao_tpu.ops import relay as jrelay
from mpc_sensorlessao_tpu.ops import zernike_stats as jzs
from mpc_sensorlessao_tpu.utils import config as jconfig
from mpc_sensorlessao_tpu_torch import interop
from mpc_sensorlessao_tpu_torch.models import mcao, tomography
from mpc_sensorlessao_tpu_torch.ops import relay, zernike
from mpc_sensorlessao_tpu_torch.ops import zernike_stats as zs
from mpc_sensorlessao_tpu_torch.utils import config

torch.backends.cuda.matmul.allow_tf32 = False
torch.set_num_threads(1)

ARCSEC = np.pi / 180 / 3600
TH = 10 * ARCSEC
GS = [(TH, 0.0), (-TH / 2, TH * 0.866), (-TH / 2, -TH * 0.866)]
LAYERS = {
    "ground": dict(fractional_r0=(1.0,), altitudes=(0.0,),
                   wind_speeds=(5.0,), wind_directions=(0.0,)),
    "high": dict(fractional_r0=(1.0,), altitudes=(8000.0,),
                 wind_speeds=(5.0,), wind_directions=(0.0,)),
    "two": dict(fractional_r0=(0.6, 0.4), altitudes=(0.0, 8000.0),
                wind_speeds=(5.0, 8.0), wind_directions=(0.0, 0.7)),
    "kolmogorov": dict(r0=0.5, L0=math.inf, fractional_r0=(1.0,),
                       altitudes=(0.0,), wind_speeds=(5.0,),
                       wind_directions=(0.0,)),
    "weak": dict(r0=1.0, fractional_r0=(1.0,), altitudes=(0.0,),
                 wind_speeds=(5.0,), wind_directions=(0.0,)),
}


def atms(name):
    return (jconfig.AtmosphereConfig(**LAYERS[name]),
            config.AtmosphereConfig(**LAYERS[name]))


def npy(t):
    return t.detach().cpu().numpy()


def t32(a):
    return torch.as_tensor(np.array(a, dtype=np.float32))


def peak_close(got, want, frac=1e-5):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-4,
                               atol=frac * float(np.abs(want).max()))


# ------------------------------------------------------------------ relay

def _screens(n, seeds, pitch, name="two", k=0):
    jatm, _ = atms(name)
    return np.stack([np.asarray(jps.synthesize_screen(
        s, jatm.layer(k), n, pitch, oversample=1)) for s in seeds])


@pytest.mark.parametrize("case", ["off-axis", "lgs-cone", "scales"])
def test_project_layers_batch_matches_jax(case):
    """Two layers of different sizes and pitches, a batch of 3 screen
    pairs in one call, against the JAX projection screen by screen."""
    pitch0, pitch1 = 1.0 / 47, 1.0 / 40
    s0 = _screens(192, [1, 2, 3], pitch0)
    s1 = _screens(160, [4, 5, 6], pitch1, k=1)
    kw = {"off-axis": dict(direction=(TH, -TH / 2)),
          "lgs-cone": dict(direction=(TH / 2, 0.0), source_height=90e3),
          "scales": dict(wavelength_ratio=550 / 589, zenith_angle=0.5)}[case]
    alts = (0.0, 8000.0)
    got = relay.project_layers([t32(s0), t32(s1)], [pitch0, pitch1], 0.5,
                               alts, 48, **kw)
    assert got.shape == (3, 48, 48) and got.dtype == torch.float32
    for b in range(3):
        want = np.asarray(jrelay.project_layers(
            [jnp.asarray(s0[b]), jnp.asarray(s1[b])], [pitch0, pitch1], 0.5,
            alts, 48, **kw))
        peak_close(npy(got[b]), want)


def test_relay_geometry_and_refusals_match_jax():
    assert relay.direction_vector(TH, 0.7) == jrelay.direction_vector(TH, 0.7)
    for h, H in ((10e3, 90e3), (5e3, math.inf)):
        assert relay.cone_compression(h, H) == jrelay.cone_compression(h, H)
    ramp = np.tile((np.arange(17) - 8.0), (17, 1)).astype(np.float32)
    rows = np.array([[8.0, 16.0, -3.0]], np.float32)
    cols = np.array([[30.0, 16.0, 2.5]], np.float32)
    np.testing.assert_array_equal(
        npy(relay._bilinear(t32(ramp), t32(rows), t32(cols))),
        np.asarray(jrelay._bilinear(jnp.asarray(ramp), jnp.asarray(rows),
                                    jnp.asarray(cols))))
    screen = t32(np.zeros((33, 33)))
    with pytest.raises(ValueError, match="footprint"):
        relay.project_layers([screen], [0.05], 0.5, [5000.0], 9,
                             direction=(1e-4, 0.0))


# ------------------------------------------------------------- tomography

@pytest.mark.parametrize("noise", ["none", "scalar", "diagonal", "lag"])
def test_tomography_build_and_estimate_match_jax(noise):
    """Two guide stars 15" apart, order 2 (the JAX quadrature's time)."""
    jatm, atm = atms("high")
    th = 15 * ARCSEC
    gs = [(th, 0.0), (-th / 2, th * 0.866)]
    kw = {"none": {}, "scalar": {"noise_cov": 0.1},
          "diagonal": {"noise_cov": np.linspace(0.01, 0.1, 5)},
          "lag": {"lag": 0.01, "science_direction": (TH, 0.0)}}[noise]
    want = jtomo.build(jatm, 1.0, 2, gs, **kw)
    got = tomography.build(atm, 1.0, 2, gs, device="cpu", **kw)
    np.testing.assert_allclose(got.err_cov, want.err_cov, rtol=1e-10,
                               atol=1e-14)
    assert got.err_var_rad2 == pytest.approx(want.err_var_rad2, rel=1e-10)
    assert got.strehl_marechal == pytest.approx(want.strehl_marechal,
                                                rel=1e-10)
    np.testing.assert_array_equal(npy(got.gain), np.asarray(want.gain))
    assert (got.n_modes, got.n_guide_stars) == (want.n_modes,
                                                want.n_guide_stars)
    x = np.random.default_rng(2).normal(size=(5, 2, 2, 5)).astype(np.float32)
    peak_close(npy(tomography.estimate(got, t32(x))),
               np.asarray(jtomo.estimate(want, jnp.asarray(x))))
    carried = interop.tomography_from_numpy(
        jax.tree.map(np.asarray, want), "cpu")
    np.testing.assert_array_equal(npy(carried.gain), npy(got.gain))
    assert carried.err_var_rad2 == want.err_var_rad2


# ------------------------------------------------------------------- MCAO

@pytest.mark.parametrize("order,alt,skip,direction", [
    (3, 0.0, 1, (TH, 0.0)), (1, 8000.0, 0, (0.0, 0.0)),
    (3, 8000.0, 3, (TH, -TH / 2))])
def test_footprint_projection_matches_jax(order, alt, skip, direction):
    fov = 4.0 * TH if alt else 60 * ARCSEC
    if order == 1:
        fov = 2.0 * np.arctan(0.5 / 8000.0)
    dm, jdm = mcao.DMLayer(alt, order, skip), jmcao.DMLayer(alt, order, skip)
    got = mcao.footprint_projection(order, dm, 1.0, fov, direction)
    want = jmcao.footprint_projection(order, jdm, 1.0, fov, direction)
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-13)
    assert dm.n_act == jdm.n_act
    assert mcao.meta_pupil_diameter(1.0, alt, fov) == \
        jmcao.meta_pupil_diameter(1.0, alt, fov)
    with pytest.raises(ValueError, match="meta-pupil"):
        mcao.footprint_projection(order, mcao.DMLayer(8000.0, order), 1.0,
                                  TH, (5 * TH, 0.0))


@pytest.mark.parametrize("noise", [0.0, 0.05])
def test_mcao_build_correct_and_coeffs_match_jax(noise):
    """A 2-DM, 2-GS, 2-direction system at order 2 with and without
    measurement noise: variances rtol 1e-10, command matrix and
    projections rtol 1e-6, batched correct / correction_coeffs 1e-4."""
    jatm, atm = atms("two")
    gs = GS[:2]
    sci = [(0.0, 0.0), (TH, 0.0)]
    args = (1.0, 4.0 * TH)
    want = jmcao.build(jatm, *args, [jmcao.DMLayer(0.0, 2),
                                     jmcao.DMLayer(8000.0, 2, 3)],
                       2, gs, sci, noise_cov=noise, resolution=32)
    got = mcao.build(atm, *args, [mcao.DMLayer(0.0, 2),
                                  mcao.DMLayer(8000.0, 2, 3)],
                     2, gs, sci, noise_cov=noise, resolution=32,
                     device="cpu")
    for key in ("scao_var_rad2", "mcao_var_rad2", "piston_free_var_rad2"):
        assert getattr(got, key) == pytest.approx(getattr(want, key),
                                                  rel=1e-10), key
    np.testing.assert_allclose(got.target_vars_rad2, want.target_vars_rad2,
                               rtol=1e-10)
    np.testing.assert_allclose(npy(got.command), np.asarray(want.command),
                               rtol=1e-6, atol=1e-6)
    for a, b in zip(got.proj, want.proj):
        np.testing.assert_allclose(npy(a), np.asarray(b), rtol=1e-6,
                                   atol=1e-7)
    assert got.n_u == want.n_u
    c = np.random.default_rng(3).normal(size=(4, 2, 5)).astype(np.float32)
    u = mcao.correct(got, t32(c))
    ju = jmcao.correct(want, jnp.asarray(c))
    peak_close(npy(u), np.asarray(ju))
    for k in range(2):
        peak_close(npy(mcao.correction_coeffs(got, u, k)),
                   np.asarray(jmcao.correction_coeffs(want, ju, k)))
    carried = interop.mcao_from_numpy(jax.tree.map(np.asarray, want), "cpu")
    np.testing.assert_array_equal(npy(carried.command),
                                  np.asarray(want.command))


# ---------------------------------------------------------- zernike_stats

ZS_CASES = {
    "residual_variance": lambda m, a: [m.residual_variance(j, a, 1.0)
                                       for j in (1, 6, 15)],
    "temporal_spectrum": lambda m, a: m.temporal_spectrum_analytic(
        np.linspace(0.0, 100.0, 41), a, 1.0, 2),
    "angular_covariance": lambda m, a: m.angular_covariance_analytic(
        a, 1.0, 2, 5e-5, azimuth=0.3, n_f=300, n_theta=64),
    "anisoplanatism": lambda m, a: m.anisoplanatism_variance(a, 1.0, 2,
                                                             5e-5),
    "coefficient_angular_covariance": lambda m, a: [
        m.coefficient_angular_covariance(a, 1.0, 2, (2e-5, -1e-5), lag=0.01,
                                         normalized=nz, n_f=300, n_theta=64)
        for nz in (False, True)],
    "variance_normalized": lambda m, a: [
        m.variance_analytic(a, 1.0, 3, normalized=True),
        m.covariance_analytic(a, 1.0, 3, normalized=True),
        m.variance_analytic(a, 1.0, 3), m.covariance_analytic(a, 1.0, 3)],
    "zernike_fourier": lambda m, a: m.zernike_fourier(
        np.array([0, 1, 2, 3, 3]), np.array([0, -1, 2, -3, 1]),
        np.linspace(0.0, 5.0, 40)[:, None] * np.ones((1, 7)),
        np.linspace(0.0, 6.0, 7)[None, :] * np.ones((40, 1)), 1.0),
    "closed_loop_variance": lambda m, a: m.closed_loop_variance(
        a, 1.0, 2, T=1 / 200, tau=1 / 200, gain=0.5, n_nu=60),
    "tip_tilt": lambda m, a: [
        m.rms_arcsec(a, 1.0, m.variance_analytic(a, 1.0, 1)[1]),
        m.anisokinetism_variance(a, 1.0, 5e-5)],
    "residue_map_and_sf": lambda m, a: [
        m.residue_variance_map(a, 1.0, 3, resolution=16),
        m.residue_structure_function(a, 1.0, 3, [0, 5, 9], [3, 7, 40],
                                     resolution=16)],
    "residue_otf_strehl_ee": lambda m, a: [
        m.residue_otf(a, 1.0, 3, resolution=16),
        m.residue_strehl_ratio(a, 1.0, 3, resolution=16),
        m.residue_entrapped_energy(a, 1.0, 3, 2.0, resolution=16)],
}
ZS_ATM = {"residual_variance": "kolmogorov", "temporal_spectrum": "two",
          "angular_covariance": "high", "anisoplanatism": "two",
          "coefficient_angular_covariance": "two",
          "variance_normalized": "two", "zernike_fourier": "ground",
          "closed_loop_variance": "ground", "tip_tilt": "high",
          "residue_map_and_sf": "weak", "residue_otf_strehl_ee": "weak"}


@pytest.mark.parametrize("case", list(ZS_CASES))
def test_zernike_stats_analytics_match_jax(case):
    jatm, atm = atms(ZS_ATM[case])
    want = ZS_CASES[case](jzs, jatm)
    got = ZS_CASES[case](zs, atm)
    if not isinstance(want, list):
        got, want = [got], [want]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w),
                                   rtol=1e-10, atol=0, equal_nan=True)


def test_anisokinetism_angle_meets_the_jax_variance():
    """The port's bisection returns the angle where the JAX package's
    tip-tilt anisoplanatism variance is 1 rad^2 (the JAX test's check)."""
    jatm, atm = atms("high")
    ang = zs.anisokinetism_angle_arcsec(atm, 1.0)
    v = jzs.anisokinetism_variance(jatm, 1.0,
                                   ang / jzs.phase_stats.RADIAN2ARCSEC)
    assert abs(v - 1.0) < 0.05


def test_zernike_helpers_match_jax():
    from mpc_sensorlessao_tpu.ops import zernike as jz
    assert [zernike.n_modes(n) for n in range(8)] == \
        [jz.n_modes(n) for n in range(8)]
    basis = zernike.make_basis(3, 24, device="cpu")
    jbasis = jz.make_basis(3, 24)
    ph = np.random.default_rng(0).normal(size=(2, 24, 24)).astype(np.float32)
    peak_close(npy(zernike.piston_removed_phase(basis, t32(ph))),
               np.asarray(jz.piston_removed_phase(jbasis, jnp.asarray(ph))))
