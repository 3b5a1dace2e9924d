"""PyTorch port vs the JAX package: the sensing and classical-control
modules -- imaging (detector + imager), the Shack-Hartmann WFS and its
reconstructors, the TSVD vault and integrator loop, the pyramid WFS, the
grid-propagated Zernike covariance and the Karhunen-Loeve basis.

The same numpy-seeded inputs go through the JAX function and its port on
CPU tensors.  Tolerances: host float64 setup (the SH operator G, the
vault's M, coefficient_covariance, KL) bit-equal where the same numpy
calls run, else rtol 1e-12; float32 products (geometric slopes,
reconstructors, the integrator's c_acc / rms with injected slope noise)
rtol 1e-4; DFT-based outputs (spots, diffractive and camera slopes,
pyramid intensities and slopes, gain_calibration's slopes_units) 1e-4 of
their peak; noisy paths the JAX tests' statistical criteria.  Sizes as in
tests/test_wfs.py (R=64, 8 lenslets), tests/test_pyramid.py (R=32) and
tests/test_integrator.py (R=48).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_sensorlessao_tpu.models import imaging as jimaging
from mpc_sensorlessao_tpu.models import integrator as jintegrator
from mpc_sensorlessao_tpu.models import pyramid as jpyramid
from mpc_sensorlessao_tpu.models import wfs as jwfs
from mpc_sensorlessao_tpu.ops import karhunen_loeve as jkl
from mpc_sensorlessao_tpu.ops import phase_screens as jps
from mpc_sensorlessao_tpu.ops import zernike as jz
from mpc_sensorlessao_tpu.ops import zernike_stats as jzs
from mpc_sensorlessao_tpu.utils import config as jconfig
from mpc_sensorlessao_tpu_torch import interop
from mpc_sensorlessao_tpu_torch.models import imaging, integrator, pyramid
from mpc_sensorlessao_tpu_torch.models import wfs
from mpc_sensorlessao_tpu_torch.ops import karhunen_loeve, psf, zernike
from mpc_sensorlessao_tpu_torch.ops import zernike_stats
from mpc_sensorlessao_tpu_torch.utils import config

torch.backends.cuda.matmul.allow_tf32 = False
torch.set_num_threads(1)

ATM1 = dict(fractional_r0=(1.0,), altitudes=(0.0,), wind_speeds=(5.0,),
            wind_directions=(0.0,))


def npy(t):
    return t.detach().cpu().numpy()


def t32(a):
    return torch.as_tensor(np.array(a, dtype=np.float32))


def peak_close(got, want, frac=1e-4, msg=""):
    """|got - want| <= frac of want's peak."""
    want = np.asarray(want)
    np.testing.assert_allclose(npy(got), want, rtol=0,
                               atol=frac * float(np.abs(want).max()),
                               err_msg=msg)


def screen_phase(R: int, scale: float = 0.3) -> np.ndarray:
    """A Von Karman phase (the screen of tests/test_wfs.py), mean-removed."""
    atm = jconfig.AtmosphereConfig(**ATM1)
    tel = jconfig.TelescopeConfig(resolution=R)
    scr = np.asarray(jps.synthesize_screen(3, atm, R, tel.pixel_pitch))
    scr = scr[:R, :R] * scale
    return (scr - scr.mean()).astype(np.float32)


# ---------------------------------------------------------------- imaging

def test_binning_and_noiseless_chain_match_jax():
    img = np.random.default_rng(0).random((2, 64, 64)).astype(np.float32)
    b = imaging.bin_frame(t32(img), 16)
    np.testing.assert_allclose(npy(b), np.asarray(jimaging.bin_frame(
        jnp.asarray(img), 16)), rtol=1e-6)
    assert float(b.sum()) == pytest.approx(float(img.sum()), rel=1e-6)
    cfg = imaging.DetectorConfig(resolution=16, quantum_efficiency=0.8)
    jcfg = jimaging.DetectorConfig(resolution=16, quantum_efficiency=0.8)
    np.testing.assert_allclose(
        npy(imaging.read_out(cfg, None, t32(img))),
        np.asarray(jimaging.read_out(jcfg, jax.random.PRNGKey(0),
                                     jnp.asarray(img))), rtol=1e-6)
    frames = np.ones((5, 8, 8), np.float32)
    out = imaging.expose(imaging.DetectorConfig(8, exposure_frames=3), None,
                         t32(frames))
    np.testing.assert_allclose(npy(out), 3.0, rtol=1e-6)


@pytest.mark.parametrize("case", ["photon", "qe", "readout", "background"])
def test_read_out_noise_law(case):
    """tests/test_imaging.py's criteria on a torch generator: Poisson mean
    = var = flux; QE after the draw (var = QE^2 flux); readout std; the
    background is drawn and subtracted (mean kept, var = flux + bg)."""
    gen = torch.Generator().manual_seed(7)
    if case == "photon":
        cfg, flux, mean, var = imaging.DetectorConfig(
            64, photon_noise=True), 50.0, 50.0, 50.0
    elif case == "qe":
        cfg, flux, mean, var = imaging.DetectorConfig(
            64, photon_noise=True, quantum_efficiency=0.5), 100.0, 50.0, 25.0
    elif case == "readout":
        cfg, flux, mean, var = imaging.DetectorConfig(
            64, read_out_noise=3.0), 0.0, 0.0, 9.0
    else:
        cfg, flux, mean, var = imaging.DetectorConfig(
            64, photon_noise=True, n_photon_background=30.0), 20.0, 20.0, 50.0
    out = npy(imaging.read_out(cfg, gen, torch.full((64, 64), flux)))
    assert out.dtype == np.float32
    assert out.mean() == pytest.approx(mean, rel=0.02, abs=0.15)
    assert out.var() == pytest.approx(var, rel=0.1)


@pytest.fixture(scope="module")
def psf_pair():
    R = 64
    basis = zernike.make_basis(3, R, device="cpu")
    pupil = psf.pupil_mask(R, device="cpu")
    flat = psf.psf_intensity(torch.zeros((R, R)), pupil, 1.0)
    aber = psf.psf_intensity(basis.stack[4], pupil, 1.0)
    return flat, aber


def test_imager_metrics_match_jax(psf_pair):
    flat, aber = psf_pair
    jf, ja = jnp.asarray(npy(flat)), jnp.asarray(npy(aber))
    for center in (False, True):
        assert float(imaging.strehl_ratio(aber, flat, center)) == \
            pytest.approx(float(jimaging.strehl_ratio(ja, jf, center)),
                          rel=1e-5)
    assert float(imaging.strehl_ratio(flat, flat)) == pytest.approx(1.0)
    for w in (4, 7, 8):
        assert float(imaging.encircled_energy(aber, w)) == pytest.approx(
            float(jimaging.encircled_energy(ja, w)), rel=1e-5)
    res = imaging.imager(imaging.DetectorConfig(32), None, 1e5 * aber[None],
                         1e5 * flat, ee_width=4)
    jres = jimaging.imager(jimaging.DetectorConfig(32), jax.random.PRNGKey(
        4), 1e5 * ja[None], 1e5 * jf, ee_width=4)
    peak_close(res.frame, jres.frame, 1e-5)
    assert float(res.strehl) == pytest.approx(float(jres.strehl), rel=1e-5)
    assert float(res.ee) == pytest.approx(float(jres.ee), rel=1e-5)
    noisy = imaging.imager(imaging.DetectorConfig(32, photon_noise=True),
                           torch.Generator().manual_seed(4),
                           1e5 * aber[None], 1e5 * flat)
    assert 0 < float(noisy.strehl) < 1 and 0 < float(noisy.ee) <= 1


def test_image_utilities_match_jax():
    for n_f in (None, 16):
        np.testing.assert_allclose(
            npy(imaging.gaussian_frame(64, 6.0, n_f, device="cpu")),
            np.asarray(jimaging.gaussian_frame(64, 6.0, n_f)),
            rtol=1e-5, atol=1e-9)
    n = 33
    u = np.arange(n, dtype=np.float64)
    x, y = np.meshgrid(u, u)
    blob = np.exp(-((x - 20.0) ** 2 + (y - 12.0) ** 2) / 8.0)
    xb, yb = imaging.barycenter(torch.as_tensor(x), torch.as_tensor(y),
                                torch.as_tensor(blob))
    jxb, jyb = jimaging.barycenter(jnp.asarray(x), jnp.asarray(y),
                                   jnp.asarray(blob))
    assert float(xb[0]) == pytest.approx(20.0, abs=1e-3)
    assert float(xb[0]) == pytest.approx(float(jxb[0]), rel=1e-6)
    assert float(yb[0]) == pytest.approx(float(jyb[0]), rel=1e-6)
    uu = np.arange(64.0) - 32.0
    X, Y = np.meshgrid(uu, uu)
    for fa, fb in ((9.0, 9.0), (12.0, 5.0)):
        sa = fa / (2.0 * np.sqrt(2.0 * np.log(2.0)))
        sb = fb / (2.0 * np.sqrt(2.0 * np.log(2.0)))
        f = np.exp(-(X / sa) ** 2 / 2.0 - (Y / sb) ** 2 / 2.0)
        f = f.astype(np.float32)
        rc = float(imaging.fit_fwhm(t32(f)))
        assert rc == pytest.approx(float(jimaging.fit_fwhm(jnp.asarray(f))),
                                   rel=1e-5)
        assert rc == pytest.approx(np.sqrt(fa * fb) / 2.0, rel=0.05)


def test_gerchberg_saxton_matches_jax(psf_pair):
    """Same seeded start, complex128 FFTs on both sides: the convergence
    trace and the retrieved in-pupil phase agree."""
    flat, aber = psf_pair
    R = flat.shape[-1]
    pupil_i = npy(psf.pupil_mask(R, device="cpu")).astype(np.float64)
    focal = npy(aber).astype(np.float64)
    phase, cv = imaging.gerchberg_saxton(torch.as_tensor(pupil_i), focal,
                                         n_iterations=25, seed=3)
    jphase, jcv = jimaging.gerchberg_saxton(pupil_i, focal,
                                            n_iterations=25, seed=3)
    np.testing.assert_allclose(npy(cv), jcv, rtol=1e-8)
    inside = pupil_i > 0
    d = np.angle(np.exp(1j * (npy(phase) - jphase)))
    assert np.abs(d[inside]).max() < 1e-6
    assert cv[-1] < cv[0]


# -------------------------------------------------------- Shack-Hartmann

R_SH, NL = 64, 8


@pytest.fixture(scope="module")
def sh_pair():
    return wfs.build(R_SH, n_lenslet=NL, device="cpu"), jwfs.build(
        R_SH, n_lenslet=NL)


@pytest.fixture(scope="module")
def basis64():
    return zernike.make_basis(4, R_SH, device="cpu"), jz.make_basis(4, R_SH)


def test_sh_build_matches_jax_exactly(sh_pair):
    """G is built from the same host float64 geometry: bit-equal."""
    sh, jsh = sh_pair
    np.testing.assert_array_equal(npy(sh.slope_op), np.asarray(jsh.slope_op))
    np.testing.assert_array_equal(sh.valid, jsh.valid)
    assert sh.sub_px == jsh.sub_px and sh.n_valid == jsh.n_valid
    op = np.asarray(jsh.dft_op)
    np.testing.assert_array_equal(npy(sh.dft_op), op[0] + 1j * op[1])
    np.testing.assert_array_equal(npy(sh.pupil), np.asarray(jsh.pupil))
    carried = interop.sh_model_from_numpy(jsh, "cpu")
    np.testing.assert_array_equal(npy(carried.sel), npy(sh.sel))
    for R, nl in ((48, 8), (80, 10)):
        a = wfs.build(R, n_lenslet=nl, device="cpu")
        b = jwfs.build(R, n_lenslet=nl)
        np.testing.assert_array_equal(npy(a.slope_op), np.asarray(b.slope_op))
    with pytest.raises(ValueError, match="divisible"):
        wfs.build(64, n_lenslet=10, device="cpu")


def test_sh_slopes_match_jax(sh_pair, basis64):
    """Geometric slopes (rtol 1e-4), spots, diffractive slopes and the
    geometric and diffractive interaction matrices (1e-4 of the peak) on
    a batch of Zernike phases."""
    sh, jsh = sh_pair
    basis, jbasis = basis64
    rng = np.random.default_rng(0)
    coeffs = np.concatenate([np.zeros((3, 1)), 0.2 * rng.normal(
        size=(3, 14))], axis=1).astype(np.float32)
    ph = npy(zernike.synthesize(basis, t32(coeffs)))
    np.testing.assert_allclose(
        ph, np.asarray(jz.synthesize(jbasis, jnp.asarray(coeffs))),
        rtol=1e-5, atol=1e-6)
    ph_t = t32(ph)
    np.testing.assert_allclose(
        npy(wfs.geometric_slopes(sh, ph_t)),
        np.asarray(jwfs.geometric_slopes(jsh, jnp.asarray(ph))),
        rtol=1e-4, atol=1e-4 * np.abs(ph).max() / sh.sub_px)
    for b in range(len(ph)):
        peak_close(wfs.spot_frames(sh, ph_t)[b],
                   jwfs.spot_frames(jsh, jnp.asarray(ph[b])), msg="spots")
        peak_close(wfs.diffractive_slopes(sh, ph_t)[b],
                   jwfs.diffractive_slopes(jsh, jnp.asarray(ph[b])),
                   msg="diffractive")
    stack, jstack = basis.stack[1:], jbasis.stack[1:]
    D = wfs.interaction_matrix(sh, stack)
    assert D.shape == (sh.n_slopes, 14)
    peak_close(D, jwfs.interaction_matrix(jsh, jstack))
    peak_close(wfs.interaction_matrix(sh, stack[:3], diffractive=True),
               jwfs.interaction_matrix(jsh, jstack[:3], diffractive=True))


def test_sh_reconstructors_match_jax(sh_pair, basis64):
    """Host float64 pinv / MMSE of the same D: rtol 1e-4 after float32;
    the LS round trip and MMSE < LS at low SNR of tests/test_wfs.py."""
    sh, _ = sh_pair
    basis, _ = basis64
    D = wfs.interaction_matrix(sh, basis.stack[1:])
    jD = jnp.asarray(npy(D))
    R_ls = wfs.ls_reconstructor(D)
    np.testing.assert_allclose(npy(R_ls), np.asarray(jwfs.ls_reconstructor(
        jD)), rtol=1e-4, atol=1e-4 * float(R_ls.abs().max()))
    C = zernike_stats.coefficient_covariance(
        config.AtmosphereConfig(), 1.0, 4, resolution=32)[1:, 1:]
    R_mm = wfs.mmse_reconstructor(D, C, 0.05 ** 2)
    np.testing.assert_allclose(
        npy(R_mm), np.asarray(jwfs.mmse_reconstructor(jD, C, 0.05 ** 2)),
        rtol=1e-4, atol=1e-4 * float(R_mm.abs().max()))
    rng = np.random.default_rng(1)
    x = 0.1 * rng.normal(size=14)
    s = wfs.geometric_slopes(sh, torch.einsum("k,kij->ij", t32(x),
                                              basis.stack[1:]))
    np.testing.assert_allclose(npy(wfs.reconstruct(R_ls, s)), x, atol=5e-3)
    Lc = np.linalg.cholesky(C + 1e-12 * np.eye(14))
    e_ls, e_mm = [], []
    Dn = npy(D).astype(np.float64)
    for _ in range(30):
        xs = Lc @ rng.standard_normal(14)
        sn = t32(Dn @ xs + 0.05 * rng.standard_normal(sh.n_slopes))
        e_ls.append(np.linalg.norm(npy(wfs.reconstruct(R_ls, sn)) - xs))
        e_mm.append(np.linalg.norm(npy(wfs.reconstruct(R_mm, sn)) - xs))
    assert np.mean(e_mm) < np.mean(e_ls)


@pytest.fixture(scope="module")
def sh80():
    ph = screen_phase(80)
    return (wfs.build(80, n_lenslet=10, device="cpu"),
            jwfs.build(80, n_lenslet=10), ph)


@pytest.mark.parametrize("case", [
    "plain", "threshold", "threshold_pair", "quad_cell", "remove_mean",
    "calibration", "n_photons"])
def test_camera_slopes_noise_free_match_jax(sh80, case):
    """The noise-free camera chain, each option against JAX (1e-4 of the
    peak), with the reference slopes subtracted."""
    sh, jsh, ph = sh80
    quad = case == "quad_cell"
    kw = {"threshold": dict(threshold=0.02),
          "threshold_pair": dict(threshold=(0.01, 0.2)),
          "remove_mean": dict(remove_mean=True),
          "calibration": dict(flat_field=-0.01, pixel_gains=3.7,
                              slopes_units=2.0),
          "n_photons": dict(n_photons=500.0, threshold=(6.0, 0.2))}.get(
        case, {})
    ref = wfs.reference_slopes(sh, quad_cell=quad)
    jref = jwfs.reference_slopes(jsh, quad_cell=quad)
    # the flat-wavefront spots are centered: both are rounding noise
    np.testing.assert_allclose(npy(ref), np.asarray(jref), atol=1e-6)
    got = wfs.camera_slopes(sh, t32(ph), None, quad_cell=quad,
                            ref_slopes=ref, **kw)
    want = jwfs.camera_slopes(jsh, jnp.asarray(ph), jax.random.PRNGKey(0),
                              quad_cell=quad, ref_slopes=jref, **kw)
    peak_close(got, want)
    if case == "plain":
        diff = wfs.diffractive_slopes(sh, t32(ph)) - ref
        np.testing.assert_allclose(npy(got), npy(diff), atol=1e-6)
        geo = npy(wfs.geometric_slopes(sh, t32(ph)))
        err = np.sqrt(np.mean((npy(got) - geo) ** 2))
        assert err < 0.15 * np.sqrt(np.mean(geo ** 2))


def test_camera_slopes_thresholding_under_noise(sh80):
    """tests/test_wfs.py's criterion on a torch generator: intensity-based
    thresholding cuts the photon/readout slope error at low flux."""
    sh, _, ph = sh80
    geo = npy(wfs.geometric_slopes(sh, t32(ph)))
    det = imaging.DetectorConfig(resolution=sh.dft_op.shape[0],
                                 photon_noise=True, read_out_noise=2.0)
    gen = torch.Generator().manual_seed(0)
    errs = {None: [], (6.0, 0.2): []}
    for thr in errs:
        for _ in range(6):
            s = npy(wfs.camera_slopes(sh, t32(ph), gen, detector=det,
                                      n_photons=200.0, threshold=thr))
            errs[thr].append(np.sqrt(np.mean((s - geo) ** 2)))
    assert np.mean(errs[(6.0, 0.2)]) < 0.75 * np.mean(errs[None])


# ------------------------------------------------------------- integrator

@pytest.fixture(scope="module")
def int_setup():
    """tests/test_integrator.py's setup (R=48, 8 lenslets, order 4), its
    numpy operators shared by both packages."""
    R = 48
    jmodel = jwfs.build(R, n_lenslet=8)
    jbasis = jz.make_basis(radial_order=4, resolution=R)
    modes = jbasis.stack[1:]
    flat = np.asarray(modes.reshape(modes.shape[0], -1))
    D = np.asarray(jwfs.interaction_matrix(jmodel, modes))
    return (np.asarray(jmodel.slope_op), flat, D,
            np.array(jbasis.mask).reshape(-1))


def test_vault_matches_jax_exactly(int_setup):
    """The same float64 SVD of the same D: bit-equal M and singular
    values, for each truncation control."""
    _, _, D, _ = int_setup
    jv = jintegrator.calibration_vault(D)
    s = jv.singular
    for kw in ({}, dict(n_thresholded=3),
               dict(threshold=(s[-3] + s[-4]) / 2),
               dict(cond=float(s[0] / s[-3]) - 1e-9)):
        v = integrator.calibration_vault(t32(D), **kw)
        j = jintegrator.calibration_vault(jnp.asarray(D), **kw)
        np.testing.assert_array_equal(npy(v.M), np.asarray(j.M))
        np.testing.assert_array_equal(v.singular, j.singular)
        assert v.n_thresholded == j.n_thresholded
        assert v.cond == j.cond
    assert integrator.calibration_vault(t32(D), n_thresholded=3) \
        .n_thresholded == 3
    with pytest.raises(ValueError, match="every mode"):
        integrator.calibration_vault(t32(D), n_thresholded=len(s))
    carried = interop.vault_from_numpy(jax.tree.map(np.asarray, jv), "cpu")
    np.testing.assert_array_equal(npy(carried.M), np.asarray(jv.M))


@pytest.mark.parametrize("cfg", [
    dict(gain=0.5), dict(gain=0.4, delay=2), dict(gain=0.3, leak=0.05,
                                                   delay=1)])
def test_closed_loop_matches_jax(int_setup, cfg):
    """The same operators, turbulence and injected slope noise through
    both loops: c_acc and rms within rtol 1e-4 (atol 1e-4 of their
    peaks), with and without the pupil mask."""
    S, flat, D, mask = int_setup
    jv = jintegrator.calibration_vault(D)
    rng = np.random.default_rng(5)
    T = 40
    t = np.linspace(0, 3 * np.pi, T)
    coefs = 0.3 * np.stack([np.sin(t + k) for k in range(flat.shape[0])],
                           axis=1)
    turb = (coefs @ flat).astype(np.float32)
    noise = (0.01 * rng.normal(size=(T, S.shape[0]))).astype(np.float32)
    for mk in (None, mask):
        c, rms = integrator.closed_loop(
            t32(S), interop.vault_from_numpy(jv, "cpu"), t32(flat),
            t32(turb), integrator.IntegratorConfig(**cfg),
            mask_flat=None if mk is None else torch.as_tensor(mk),
            slope_noise=t32(noise))
        jc, jrms = jintegrator.closed_loop(
            jnp.asarray(S), jv, jnp.asarray(flat), jnp.asarray(turb),
            jintegrator.IntegratorConfig(**cfg),
            mask_flat=None if mk is None else jnp.asarray(mk),
            slope_noise=jnp.asarray(noise))
        for got, want in ((c, jc), (rms, jrms)):
            want = np.asarray(want)
            np.testing.assert_allclose(npy(got), want, rtol=1e-4,
                                       atol=1e-4 * np.abs(want).max())


def test_integrator_latency_and_convergence(int_setup):
    """tests/test_integrator.py's behaviours: one frame of actuation
    latency at delay 0, convergence on a static aberration, delay slows
    but converges."""
    S, flat, D, _ = int_setup
    vault = integrator.calibration_vault(t32(D))
    a = (np.random.default_rng(0).normal(size=flat.shape[0]) * 0.3
         ).astype(np.float32)
    phi = t32(a) @ t32(flat)
    turb = phi[None].repeat(60, 1)
    c0, rms0 = integrator.closed_loop(t32(S), vault, t32(flat), turb,
                                      integrator.IntegratorConfig(0.4))
    _, rms2 = integrator.closed_loop(t32(S), vault, t32(flat), turb,
                                     integrator.IntegratorConfig(0.4,
                                                                 delay=2))
    assert float(rms0[0]) == pytest.approx(
        float(torch.sqrt(torch.mean(phi * phi))), rel=1e-5)
    assert float(rms0[1]) < float(rms0[0])
    assert float(rms0[-1]) < 0.02 * float(rms0[0])
    np.testing.assert_allclose(npy(c0[-1]), a, atol=0.05)
    assert float(rms2[5]) > float(rms0[5])
    assert float(rms2[-1]) < 0.05 * float(rms2[0])


# ---------------------------------------------------------------- pyramid

R_PYR, NL_PYR = 32, 8


@pytest.fixture(scope="module", params=[0.0, 3.0], ids=["mod0", "mod3"])
def pyr_pair(request):
    mod = request.param
    return (pyramid.build(R_PYR, NL_PYR, modulation=mod, device="cpu"),
            jpyramid.build(R_PYR, NL_PYR, modulation=mod))


@pytest.fixture(scope="module")
def basis32():
    return zernike.make_basis(3, R_PYR, device="cpu"), jz.make_basis(3, R_PYR)


def test_pyramid_build_matches_jax(pyr_pair):
    """Mask and phasors from the same float64 host code: bit-equal to
    the JAX real/imag pairs; the flat-wavefront reference slopes zero to
    1e-6 in both."""
    m, jm = pyr_pair
    mask = np.asarray(jm.pyr_mask)
    np.testing.assert_array_equal(npy(m.pyr_mask), mask[0] + 1j * mask[1])
    ph = np.asarray(jm.phasors)
    np.testing.assert_array_equal(npy(m.phasors), ph[:, 0] + 1j * ph[:, 1])
    np.testing.assert_array_equal(npy(m.pupil), np.asarray(jm.pupil))
    np.testing.assert_array_equal(m.valid, jm.valid)
    assert (m.px_side, m.n_valid, m.n_slopes) == (jm.px_side, jm.n_valid,
                                                  jm.n_slopes)
    # a flat wavefront lights the four quadrants alike: rounding noise
    np.testing.assert_allclose(npy(m.reference_slopes),
                               np.asarray(jm.reference_slopes), atol=1e-6)
    flat = pyramid.slopes(m, torch.zeros(R_PYR, R_PYR))
    assert float(flat.abs().max()) < 1e-6


def test_pyramid_slopes_match_jax(pyr_pair, basis32):
    """Detector images and slopes of Zernike phases within 1e-4 of their
    peak, through the port's build and through the JAX model carried
    across; the interaction matrix likewise."""
    m, jm = pyr_pair
    basis, jbasis = basis32
    rng = np.random.default_rng(0)
    coeffs = np.concatenate([np.zeros((2, 1)), 0.1 * rng.normal(
        size=(2, 9))], axis=1).astype(np.float32)
    ph = zernike.synthesize(basis, t32(coeffs))
    carried = interop.pyramid_model_from_numpy(jm, "cpu")
    for b in range(2):
        jph = jnp.asarray(npy(ph[b]))
        peak_close(pyramid.intensity_map(m, ph)[b],
                   jpyramid.intensity_map(jm, jph), msg="image")
        want = jpyramid.slopes(jm, jph)
        peak_close(pyramid.slopes(m, ph)[b], want, msg="slopes")
        peak_close(pyramid.slopes(carried, ph[b]), want, msg="carried")
    peak_close(pyramid.interaction_matrix(m, basis.stack[1:4]),
               jpyramid.interaction_matrix(jm, jbasis.stack[1:4]))


def test_pyramid_gain_calibration_matches_jax(basis32):
    """slopes_units from the 5-point ramp within 1e-4 of JAX's, and the
    calibrated tilt response is 4a (tests/test_pyramid.py)."""
    basis, jbasis = basis32
    m = pyramid.build(R_PYR, NL_PYR, modulation=3.0, device="cpu")
    jm = jpyramid.build(R_PYR, NL_PYR, modulation=3.0)
    cal = pyramid.gain_calibration(m, basis.stack[1])
    jcal = jpyramid.gain_calibration(jm, jbasis.stack[1])
    assert cal.slopes_units == pytest.approx(float(jcal.slopes_units),
                                             rel=1e-4)
    s = pyramid.slopes(cal, 0.08 * basis.stack[1])
    assert float(s[m.n_valid:].mean()) == pytest.approx(4 * 0.08, rel=0.1)


def test_pyramid_modulation_trade_off(basis32):
    """tests/test_pyramid.py: unmodulated saturates early, modulated keeps
    responding, at a lower small-signal gain."""
    tilt = basis32[0].stack[1]
    m0 = pyramid.build(R_PYR, NL_PYR, modulation=0.0, device="cpu")
    m3 = pyramid.build(R_PYR, NL_PYR, modulation=3.0, device="cpu")

    def mean_sy(model, a):
        return float(pyramid.slopes(model, a * tilt)[model.n_valid:].mean())

    assert mean_sy(m0, 8.0) / mean_sy(m0, 1.0) < 2.0
    assert mean_sy(m3, 8.0) / mean_sy(m3, 1.0) > 5.0
    assert abs(mean_sy(m3, 0.05)) < abs(mean_sy(m0, 0.05))


# ------------------------------------------ Zernike covariance, KL modes

@pytest.mark.parametrize("piston_removed", [True, False])
def test_coefficient_covariance_matches_jax(piston_removed):
    """Host float64 through the port's covariance_matrix and Zernike
    evaluation: the same numpy calls, so bit-equal (rtol 1e-12 is the
    stated bound)."""
    atm = config.AtmosphereConfig(**ATM1)
    jatm = jconfig.AtmosphereConfig(**ATM1)
    C = zernike_stats.coefficient_covariance(atm, 1.0, 4, 24, piston_removed)
    jC = jzs.coefficient_covariance(jatm, 1.0, 4, 24, piston_removed)
    np.testing.assert_allclose(C, jC, rtol=1e-12, atol=1e-12 * np.abs(
        jC).max())
    np.testing.assert_allclose(
        zernike_stats.coefficient_variances(atm, 1.0, 4, 24, piston_removed),
        np.diag(jC), rtol=1e-12)
    if piston_removed:
        v = zernike_stats.total_residual_variance(atm, 1.0, 4, 24)
        assert v == pytest.approx(jzs.total_residual_variance(jatm, 1.0, 4,
                                                              24), rel=1e-12)
        assert v > zernike_stats.total_residual_variance(atm, 1.0, 6, 24)


def test_kl_basis_matches_jax():
    """Eigenvectors of the same covariance (signs included) and the mode
    maps: the float32 roundings of the same float64 arrays."""
    atm = config.AtmosphereConfig()
    grid = zernike.make_basis(4, 32, device="cpu")
    kl = karhunen_loeve.make_basis(atm, 1.0, 4, grid_basis=grid,
                                   resolution=32, device="cpu")
    jkb = jkl.make_basis(jconfig.AtmosphereConfig(), 1.0, 4,
                         grid_basis=jz.make_basis(4, 32), resolution=32)
    for name in ("to_zernike", "variances", "stack"):
        np.testing.assert_array_equal(npy(getattr(kl, name)),
                                      np.asarray(getattr(jkb, name)),
                                      err_msg=name)
    v = npy(kl.variances)
    assert (np.diff(v) <= 1e-6).all()
    C = zernike_stats.coefficient_covariance(atm, 1.0, 4, resolution=32)
    assert abs(v.sum() / np.trace(C[1:, 1:]) - 1.0) < 1e-5
    x = t32(np.random.default_rng(3).normal(size=14))
    np.testing.assert_allclose(
        npy(karhunen_loeve.synthesize(kl, karhunen_loeve.project(kl, x))),
        npy(x), atol=1e-5)
    carried = interop.kl_basis_from_numpy(jkb, "cpu")
    np.testing.assert_array_equal(npy(carried.to_zernike),
                                  np.asarray(jkb.to_zernike))
    assert karhunen_loeve.make_basis(atm, 1.0, 4, resolution=32,
                                     device="cpu").stack is None
