"""PyTorch port vs the JAX package: the laser guide star, Fourier-AO
error budget, analytic telescope optics, paraxial ray tracing and the
segmented pupil.

The same numpy-seeded inputs go through the JAX function and its port.
Tolerances: host numpy float64 analytics (fourier_ao, telescope_optics,
segmented, lgs.build's weights and angular size, raytrace.system_matrix)
rtol 1e-10; float32 device paths (elongation offsets and kernels,
elongated spots, traced rays) rtol 1e-4 or atol 1e-5 of the peak.  Sizes
as in tests/test_lgs.py, test_fourier_ao.py, test_telescope_optics.py,
test_raytrace.py and test_units_segmented.py.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_sensorlessao_tpu.models import lgs as jlgs
from mpc_sensorlessao_tpu.models import wfs as jwfs
from mpc_sensorlessao_tpu.ops import fourier_ao as jfao
from mpc_sensorlessao_tpu.ops import raytrace as jrt
from mpc_sensorlessao_tpu.ops import segmented as jseg
from mpc_sensorlessao_tpu.ops import telescope_optics as jtopt
from mpc_sensorlessao_tpu.utils import config as jconfig
from mpc_sensorlessao_tpu_torch import interop
from mpc_sensorlessao_tpu_torch.models import lgs, wfs
from mpc_sensorlessao_tpu_torch.ops import fourier_ao, raytrace, segmented
from mpc_sensorlessao_tpu_torch.ops import telescope_optics as topt
from mpc_sensorlessao_tpu_torch.utils import config

torch.backends.cuda.matmul.allow_tf32 = False
torch.set_num_threads(1)

HEIGHTS = 1e3 * (np.arange(-5, 6) + 90.0)


def npy(t):
    return t.detach().cpu().numpy()


def t32(a):
    return torch.as_tensor(np.array(a, dtype=np.float32))


def peak_close(got, want, frac=1e-5):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-4,
                               atol=frac * float(np.abs(want).max()))


def exact(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-10, atol=0, equal_nan=True)


# -------------------------------------------------------------------- LGS

@pytest.mark.parametrize("profile", ["flat", "peaked"])
def test_lgs_build_offsets_and_size_match_jax(profile):
    rho = None if profile == "flat" else np.exp(
        -0.5 * ((HEIGHTS - 91e3) / 2e3) ** 2)
    kw = dict(na_density=rho, launch=(-0.5, 0.2), n_photon=3e6)
    want = jlgs.build(HEIGHTS, **kw)
    got = lgs.build(HEIGHTS, device="cpu", **kw)
    np.testing.assert_array_equal(npy(got.weights), np.asarray(want.weights))
    np.testing.assert_array_equal(npy(got.heights), np.asarray(want.heights))
    assert got.mean_altitude == want.mean_altitude
    assert got.n_photon == want.n_photon
    pos = lgs.subaperture_positions(10, 1.0)
    exact(pos, jlgs.subaperture_positions(10, 1.0))
    peak_close(npy(lgs.elongation_offsets(got, pos)),
               np.asarray(jlgs.elongation_offsets(want, pos)))
    assert lgs.angular_size_arcsec(25.0, HEIGHTS, 90e3) == \
        jlgs.angular_size_arcsec(25.0, HEIGHTS, 90e3)
    carried = interop.lgs_model_from_numpy(jax.tree.map(np.asarray, want),
                                           "cpu")
    np.testing.assert_array_equal(npy(carried.weights), npy(got.weights))
    assert carried.mean_altitude == got.mean_altitude


@pytest.mark.parametrize("kw,fwhm", [(9, 0.0), (8, 0.0), (9, 1.5), (8, 1.5),
                                     (6, 3.0)])
def test_elongation_kernels_and_spots_match_jax(kw, fwhm):
    """Odd and even kernel widths, with and without the Na-spot blur
    (scipy 'same' centering for an even width), then the grouped
    convolution with its (pad, kw-1-pad) padding, on a batch of two
    phases against the JAX function phase by phase."""
    model = lgs.build(HEIGHTS, launch=(-0.5, 0.0), device="cpu")
    jmodel = jlgs.build(HEIGHTS, launch=(-0.5, 0.0))
    pos = lgs.subaperture_positions(10, 1.0)
    ker = lgs.elongation_kernels(model, pos, 2e-7, kw, fwhm)
    jker = jlgs.elongation_kernels(jmodel, pos, 2e-7, kw, fwhm)
    peak_close(npy(ker), np.asarray(jker))
    sh, jsh = wfs.build(80, n_lenslet=10, device="cpu"), jwfs.build(80, 10)
    ph = np.random.default_rng(kw).normal(0, 0.5, (2, 80, 80))
    ph = ph.astype(np.float32)
    spots = wfs.spot_frames(sh, t32(ph))
    el = lgs.elongate_spots(spots, ker)
    assert el.shape == spots.shape
    for b in range(2):
        jspots = jwfs.spot_frames(jsh, jnp.asarray(ph[b]))
        want = np.asarray(jlgs.elongate_spots(jspots, jker))
        peak_close(npy(el[b]), want)


# ------------------------------------------------------------- Fourier AO

def _fao_cfgs(**kw):
    base = dict(diameter=1.0, n_actuator=12, noise_variance=0.1,
                loop_gain=0.5, exposure_time=1 / 200.0, latency=1 / 200.0)
    base.update(kw)
    return (jfao.FourierAOConfig(atm=jconfig.AtmosphereConfig(), **base),
            fourier_ao.FourierAOConfig(atm=config.AtmosphereConfig(), **base))


FAO_CASES = {
    "psd_terms": lambda m, c, fx, fy: [
        m.fitting_psd(c, fx, fy), m.noise_psd(c, fx, fy),
        m.aliasing_psd(c, fx, fy), m.servo_lag_psd(c, fx, fy),
        m.anisoplanatism_psd(c, fx, fy, (2e-5, 1e-5)),
        m.power_spectrum_density(c, fx, fy, direction=(1e-5, 0.0)),
        m.piston_filter(c, np.hypot(fx, fy))],
    "temporal_tfs": lambda m, c, fx, fy: [
        m.closed_loop_rejection(c, np.linspace(0, 400, 81)),
        m.closed_loop_aliasing(c, np.linspace(0, 400, 81)),
        m.closed_loop_noise(c, np.linspace(0, 400, 81)),
        m._average_tf(c, fx, fy, m.closed_loop_rejection)],
    "variances": lambda m, c, fx, fy: [
        m.var_fitting(c, n=128), m.var_servo_lag(c), m.var_noise(c),
        m.var_total(c, n=128), c.fc],
    "psf": lambda m, c, fx, fy: list(m.psf(c, 64, 20.0)),
}


@pytest.mark.parametrize("case", list(FAO_CASES))
def test_fourier_ao_matches_jax(case):
    jcfg, cfg = _fao_cfgs()
    g = np.linspace(-3 * cfg.fc, 3 * cfg.fc, 48)
    fx, fy = np.meshgrid(g, g)
    want = FAO_CASES[case](jfao, jcfg, fx, fy)
    got = FAO_CASES[case](fourier_ao, cfg, fx, fy)
    for a, b in zip(got, want):
        exact(a, b)


# ------------------------------------------------------- telescope optics

def test_telescope_optics_matches_jax():
    jatm = jconfig.AtmosphereConfig(fractional_r0=(1.0,), altitudes=(0.0,),
                                    wind_speeds=(5.0,), wind_directions=(0.0,))
    atm = config.AtmosphereConfig(**{f.name: getattr(jatm, f.name)
                                     for f in dataclasses.fields(jatm)})
    r = np.linspace(0.0, 1.2, 61)
    f = np.linspace(0.0, 4.0, 41)
    pairs = [
        (topt.diffraction_otf(r, 1.0), jtopt.diffraction_otf(r, 1.0)),
        (topt.diffraction_otf(r, 1.0, 0.3), jtopt.diffraction_otf(r, 1.0,
                                                                  0.3)),
        (topt.atmospheric_otf(r, atm), jtopt.atmospheric_otf(r, jatm)),
        (topt.long_exposure_otf(r, 1.0, atm, 0.2),
         jtopt.long_exposure_otf(r, 1.0, jatm, 0.2)),
        (topt.airy_psf(f, 1.0, 0.3), jtopt.airy_psf(f, 1.0, 0.3)),
        (topt.psf_radial(f, 1.0, atm, 0.1, n_quad=512),
         jtopt.psf_radial(f, 1.0, jatm, 0.1, n_quad=512)),
        (topt.strehl_ratio(1.0, atm), jtopt.strehl_ratio(1.0, jatm))]
    for a, b in pairs:
        exact(a, b)


# -------------------------------------------------------------- ray trace

def _chains(m):
    f1, f2 = 0.2, 0.4
    return {
        "4f": [m.free_space(f1), m.thin_lens(f1), m.free_space(f1 + f2),
               m.thin_lens(f2), m.free_space(f2)],
        "mirror": [m.free_space(0.3, stop_width=0.08),
                   m.curved_mirror(1.0, offset=0.002, stop_width=0.05),
                   m.free_space(0.5, stop_offset=0.01, stop_width=0.04)],
        "telephoto": [m.thin_lens(f1), m.free_space(0.1), m.thin_lens(f2)]}


@pytest.mark.parametrize("chain", ["4f", "mirror", "telephoto"])
def test_raytrace_matches_jax(chain):
    sys_, jsys = _chains(raytrace)[chain], _chains(jrt)[chain]
    rays = np.random.default_rng(0).normal(
        0, [0.02, 0.01], (3, 1000, 2)).astype(np.float32)
    out, ok, z, zdir = raytrace.trace(sys_, t32(rays))
    jout, jok, jz, jzdir = jrt.trace(jsys, jnp.asarray(rays))
    peak_close(npy(out), np.asarray(jout))
    np.testing.assert_array_equal(npy(ok), np.asarray(jok))
    assert (z, zdir) == (jz, jzdir)
    peak_close(npy(raytrace.trace_path(sys_, t32(rays[0]))),
               np.asarray(jrt.trace_path(jsys, jnp.asarray(rays[0]))))
    if chain == "mirror":
        with pytest.raises(ValueError, match="offset-free"):
            raytrace.system_matrix(sys_)
    else:
        exact(raytrace.system_matrix(sys_), jrt.system_matrix(jsys))
        eff, jeff = (raytrace.effective_focal_length(sys_),
                     jrt.effective_focal_length(jsys))
        assert eff == jeff or (math.isinf(eff) and math.isinf(jeff))


# -------------------------------------------------------------- segmented

def test_segmented_matches_jax():
    for n_cycle in (1, 2, 3):
        for a, b in zip(segmented.hexagonal_array(n_cycle, 1.3),
                        jseg.hexagonal_array(n_cycle, 1.3)):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        segmented.hex_mask(1.0, 96, x0=0.2, y0=-0.1, span=4.0),
        jseg.hex_mask(1.0, 96, x0=0.2, y0=-0.1, span=4.0))
    valid = np.array([1, 0, 1, 1, 0, 1, 1], dtype=bool)
    for v in (None, valid):
        for a, b in zip(segmented.ptt_basis(1, 64, valid=v),
                        jseg.ptt_basis(1, 64, valid=v)):
            np.testing.assert_array_equal(a, b)
