"""PyTorch port vs the JAX package: the utilities -- units, photometry,
gridtools, logbook and display.

Host float64 helpers must agree with the JAX package's bit for bit (the
same numpy code runs); the tensor ops (gridtools.mean_sub, toggle_frame,
units.heaviside) run on CPU tensors against the JAX functions on the
same numpy inputs (rtol 1e-6, float32).  The display checks are those of
tests/test_display.py, fed tensors.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from mpc_sensorlessao_tpu.models.closed_loop import StepOutputs as JStepOutputs
from mpc_sensorlessao_tpu.utils import gridtools as jgt
from mpc_sensorlessao_tpu.utils import logbook as jlogbook
from mpc_sensorlessao_tpu.utils import photometry as jphot
from mpc_sensorlessao_tpu.utils import units as junits
from mpc_sensorlessao_tpu_torch.models.closed_loop import StepOutputs
from mpc_sensorlessao_tpu_torch.utils import display, gridtools, logbook
from mpc_sensorlessao_tpu_torch.utils import photometry, units

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parents[1]


# ---------------------------------------------------------------- units

def test_unit_constants_and_conversions_match_jax():
    for name in ("RADIAN2ARCSEC", "RADIAN2MAS", "RADIAN2ARCMIN",
                 "ARCSEC2RADIAN", "ARCMIN2RADIAN", "PLANCK", "C_LIGHT",
                 "M_EARTH", "R_EARTH", "G_GRAV"):
        assert getattr(units, name) == getattr(junits, name), name
    assert units.arcsec(1.0) == pytest.approx(4.84813681e-6, rel=1e-8)
    for u in ("radian", "arcmin", "arcsec", "mas", "degree"):
        assert units.from_unit(1.234, u) == junits.from_unit(1.234, u)
        assert units.to_unit(units.from_unit(1.234, u), u) == pytest.approx(
            1.234, rel=1e-12)
    for fn in ("arcsec", "arcmin", "mas"):
        assert getattr(units, fn)(3.7) == getattr(junits, fn)(3.7)
    lam, rms = 550e-9, 0.3 / (2 * np.pi) * 550e-9
    assert units.marechal_strehl(rms, lam) == junits.marechal_strehl(rms,
                                                                     lam)


def test_sky_angle_value_class():
    a = units.SkyAngle.of(30.0, "arcsec")
    assert a.arcsec == pytest.approx(30.0)
    assert a.arcmin == pytest.approx(0.5)
    assert a.mas == pytest.approx(30e3)
    assert a.degree == junits.SkyAngle.of(30.0, "arcsec").degree
    b = a + units.SkyAngle.of(30.0, "arcsec")
    assert b.arcmin == pytest.approx(1.0)
    assert str(a) == str(junits.SkyAngle.of(30.0, "arcsec"))


@pytest.mark.parametrize("kind", ["numpy", "tensor"])
def test_heaviside_matches_jax(kind):
    """H(0) = 1/2; a tensor stays a tensor."""
    x = np.array([-1.0, 0.0, 2.0, -0.0, 1e-30], np.float32)
    want = np.asarray(junits.heaviside(x))
    got = units.heaviside(torch.as_tensor(x) if kind == "tensor" else x)
    assert isinstance(got, torch.Tensor) == (kind == "tensor")
    np.testing.assert_array_equal(np.asarray(got), want)


# ----------------------------------------------------------- photometry

def test_bands_match_jax():
    assert set(photometry.BANDS) == set(jphot.BANDS)
    assert set(photometry.GMT_BANDS) == set(jphot.GMT_BANDS)
    for ours, theirs in ((photometry.BANDS, jphot.BANDS),
                         (photometry.GMT_BANDS, jphot.GMT_BANDS)):
        for name, b in ours.items():
            j = theirs[name]
            assert (b.name, b.wavelength, b.bandwidth, b.zero_point) == (
                j.name, j.wavelength, j.bandwidth, j.zero_point), name
            assert b.n_photon(12.5) == j.n_photon(12.5)
            assert b.n_background(20.0, 0.25) == j.n_background(20.0, 0.25)
    assert photometry.GMT_BANDS["V"].zero_point * 368.0 == pytest.approx(
        3.3e12)


def test_band_combine_and_scales_match_jax():
    c = photometry.combine(photometry.band("V"), photometry.band("R"))
    j = jphot.combine(jphot.band("V"), jphot.band("R"))
    assert (c.name, c.wavelength, c.bandwidth, c.zero_point) == (
        j.name, j.wavelength, j.bandwidth, j.zero_point)
    assert photometry.band("V").wavelength < c.wavelength < \
        photometry.band("R").wavelength
    assert photometry.wavelength_scale(photometry.V, photometry.K) == \
        jphot.wavelength_scale(jphot.V, jphot.K)
    assert photometry.rad_to_nm(1.65e-6) == jphot.rad_to_nm(1.65e-6)


# ------------------------------------------------------------ gridtools

def test_mean_sub_matches_jax():
    rng = np.random.default_rng(0)
    d = rng.normal(size=(3, 8, 8)).astype(np.float32)
    m = np.zeros((8, 8), bool)
    m[2:6, 2:6] = True
    out = gridtools.mean_sub(torch.as_tensor(d), torch.as_tensor(m))
    assert isinstance(out, torch.Tensor)
    np.testing.assert_allclose(out.numpy(), np.asarray(jgt.mean_sub(d, m)),
                               rtol=1e-6, atol=1e-6)
    assert np.abs(out.numpy()[:, m].mean(axis=1)).max() < 1e-6
    np.testing.assert_array_equal(out.numpy()[:, ~m], d[:, ~m])


def test_toggle_frame_matches_jax():
    rng = np.random.default_rng(1)
    cube = rng.normal(size=(6, 6, 4)).astype(np.float32)
    flat = gridtools.toggle_frame(torch.as_tensor(cube), 2)
    np.testing.assert_array_equal(flat.numpy(),
                                  np.asarray(jgt.toggle_frame(cube, 2)))
    np.testing.assert_array_equal(gridtools.toggle_frame(flat).numpy(), cube)
    two = rng.normal(size=(36, 3)).astype(np.float32)
    np.testing.assert_array_equal(gridtools.toggle_frame(two, 2).numpy(),
                                  two)
    np.testing.assert_array_equal(
        gridtools.toggle_frame(two, 3).numpy(),
        np.asarray(jgt.toggle_frame(two, 3)))
    with pytest.raises(ValueError):
        gridtools.toggle_frame(np.zeros((35, 2), np.float32), 3)


def test_host_gridtools_match_jax_exactly():
    """The host float64 helpers run the JAX package's numpy code."""
    rng = np.random.default_rng(2)
    for out in ("all", "polar", "cartesian"):
        for a, b in zip(gridtools.cart_and_pol(9, 2.0, out),
                        jgt.cart_and_pol(9, 2.0, out)):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(gridtools.rearrange((8, 12), (4, 3)),
                                  jgt.rearrange((8, 12), (4, 3)))
    assert sorted(gridtools.rearrange((8, 8), (4, 4)).ravel().tolist()) \
        == list(range(64))
    for fn, args in (("fitting_error_variance", (1.0, 0.2, 42.0, 100)),
                     ("defocus_distance", (3.0, 0.2, 0.01, 532e-9)),
                     ("out_of_focus", (1e-4, 0.2, 0.01, 532e-9)),
                     ("orbital_velocity", (90e3, 0.3)),
                     ("point_ahead_angle", (90e3, 0.3))):
        assert getattr(gridtools, fn)(*args) == getattr(jgt, fn)(*args), fn
    a4 = 3.0
    dz = gridtools.defocus_distance(a4, 0.2, 0.01, 532e-9)
    assert abs(gridtools.out_of_focus(dz, 0.2, 0.01, 532e-9) - a4) < 1e-9
    V = rng.normal(size=(10, 4))
    Q = gridtools.gram_schmidt(V)
    np.testing.assert_array_equal(Q, jgt.gram_schmidt(V))
    np.testing.assert_allclose(Q.T @ Q, np.eye(4), atol=1e-10)
    A = rng.normal(size=(2, 3))
    np.testing.assert_array_equal(gridtools.eye_block_diag(A, 3),
                                  jgt.eye_block_diag(A, 3))
    xi, yi = rng.uniform(0, 4, 7), rng.uniform(0, 4, 7)
    g = np.arange(5.0)
    xo, yo = np.meshgrid(g, g)
    H = gridtools.bilinear_interp_matrix(xi, yi, xo, yo, 1.0)
    np.testing.assert_array_equal(H, jgt.bilinear_interp_matrix(
        xi, yi, xo, yo, 1.0))
    np.testing.assert_allclose(H.sum(axis=1), 1.0, rtol=1e-12)


# -------------------------------------------------------------- logbook

def test_logbook_capture_keeps_jax_semantics():
    """capture() yields the entries appended inside the context, each
    (time, level, sender name, message), as the JAX log book does; the
    port's log book is its own singleton."""
    with logbook.capture() as entries, jlogbook.capture() as jentries:
        logbook.add("turb", "screen synthesized")
        logbook.add(1.5, "1 newton step", level="debug")
    tail = entries()
    assert [e[1:] for e in tail] == [
        ("info", "turb", "screen synthesized"),
        ("debug", "float", "1 newton step")]
    assert jentries() == []
    assert logbook.logbook() is logbook.logbook()
    assert logbook.logbook().tail(2) == tail
    assert logbook._LOGGER.name == "mpc_sensorlessao_tpu_torch"


# -------------------------------------------------------------- display

@pytest.fixture
def mpl():
    matplotlib = pytest.importorskip("matplotlib")
    matplotlib.use("Agg", force=True)
    return matplotlib


def test_display_imports_matplotlib_lazily():
    """Importing the module pulls in no matplotlib: the card machine has
    none."""
    code = ("import sys; import mpc_sensorlessao_tpu_torch.utils.display; "
            "sys.exit('matplotlib' in sys.modules)")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    assert subprocess.run([sys.executable, "-c", code], env=env,
                          timeout=120).returncode == 0


def test_show_phase_masks_outside(mpl, tmp_path):
    rng = np.random.default_rng(0)
    ph = torch.as_tensor(rng.normal(size=(32, 32)))
    mask = np.hypot(*np.meshgrid(*[np.arange(32) - 15.5] * 2)) < 14
    out = os.path.join(tmp_path, "phase.png")
    fig = display.show_phase(ph, torch.as_tensor(mask), save=out,
                             close=True)
    assert os.path.exists(out) and os.path.getsize(out) > 0
    arr = np.asarray(fig.axes[0].images[0].get_array())
    assert np.isnan(arr[~mask]).all()
    np.testing.assert_array_equal(arr[mask], ph.numpy()[mask])


def test_show_psf_log_stretch(mpl, tmp_path):
    img = torch.zeros((31, 31))
    img[15, 15] = 1.0
    out = os.path.join(tmp_path, "psf.png")
    fig = display.show_psf(img, save=out, close=True)
    assert os.path.getsize(out) > 0
    arr = np.asarray(fig.axes[0].images[0].get_array())
    assert arr.max() == 0.0 and arr.min() == pytest.approx(-8.0)


def test_show_telemetry(mpl, tmp_path):
    T, nu, nx = 12, 4, 3
    z = torch.zeros((T, nu))
    o = StepOutputs(
        u=z, du=z, volts=z, x_est=torch.zeros((T, nx)),
        x_est_norm=torch.zeros(T), x_pred_norm=torch.zeros(T),
        cost=torch.zeros(T), rms_res=0.2 * torch.ones(T),
        rms_turb=0.5 * torch.ones(T), strehl=0.9 * torch.ones(T),
        strehl_exact=0.95 * torch.ones(T))
    assert set(o._fields) == set(JStepOutputs._fields)
    out = os.path.join(tmp_path, "telemetry.png")
    fig = display.show_telemetry(o, save=out, close=True)
    assert len(fig.axes) == 3
    assert os.path.getsize(out) > 0


def test_polar_surface(mpl, tmp_path):
    rng = np.random.default_rng(1)
    th = torch.as_tensor(rng.uniform(0, 2 * np.pi, 50))
    rho = torch.as_tensor(rng.uniform(0, 1, 50))
    z = torch.cos(th) * rho
    out = os.path.join(tmp_path, "polar.png")
    fig = display.polar_surface(th, rho, z, n_grid=32, save=out, close=True)
    assert os.path.getsize(out) > 0
    assert np.isfinite(np.asarray(fig.axes[0].images[0].get_array())).any()
