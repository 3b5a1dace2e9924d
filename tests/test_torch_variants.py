"""PyTorch port vs the JAX package: the variants of ported modules -- the
"straight" and "cholesky" screens and explicit oversampling,
make_layers(cover_steps=...), zernike.fit / synthesize, and the Bezier
DM influence through pipeline.build.

Screens and DM maps are host float64 numpy in both packages from the
same integer seeds: bit-equal.  The DM's modal influence is that float64
projection rounded to float32 (rtol 1e-5, as tests/test_torch_ops.py's
Gaussian case); fit/synthesize are float32 matmuls (rtol 1e-5).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_sensorlessao_tpu.models import dm as jdm
from mpc_sensorlessao_tpu.ops import phase_screens as jps
from mpc_sensorlessao_tpu.ops import zernike as jz
from mpc_sensorlessao_tpu.utils import config as jconfig
from mpc_sensorlessao_tpu_torch import reference_config
from mpc_sensorlessao_tpu_torch.models import dm, pipeline
from mpc_sensorlessao_tpu_torch.ops import phase_screens, zernike

torch.set_num_threads(1)


def npy(t):
    return t.detach().cpu().numpy()


def _atm_pitch(R: int):
    cfg, jcfg = reference_config(R), jconfig.reference_config(R)
    return (cfg.atmosphere.layer(0), jcfg.atmosphere.layer(0),
            cfg.telescope.pixel_pitch * 128 / R)


@pytest.mark.parametrize("method,n,os_", [
    ("straight", 32, 2), ("straight", 24, 1), ("cholesky", 16, 2),
    ("cholesky", 12, 1), ("fourier", 16, 3)])
def test_screen_methods_identical_to_jax(method, n, os_):
    """The same numpy draws from SeedSequence([seed]): bit-equal."""
    atm, jatm, pitch = _atm_pitch(n)
    got = phase_screens.synthesize_screen(11, atm, n, pitch, oversample=os_,
                                          method=method)
    want = np.asarray(jps.synthesize_screen(11, jatm, n, pitch,
                                            oversample=os_, method=method))
    assert got.shape == (os_ * n, os_ * n) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert np.isfinite(got).all() and got.std() > 0


@pytest.mark.parametrize("threads,rows", [(1, 32), (8, 32), (3, 7)])
def test_subharmonic_bands_identical_to_jax(monkeypatch, threads, rows):
    """The subharmonic patches summed in bands of rows on host threads
    (a ragged last band at N=150) give the JAX package's one-pass
    screen, bit for bit, at any thread count and band height."""
    monkeypatch.setattr(phase_screens, "SCREEN_THREADS", threads)
    monkeypatch.setattr(phase_screens, "SUBHARMONIC_ROWS", rows)
    atm, jatm, pitch = _atm_pitch(75)
    got = phase_screens.synthesize_screen(13, atm, 75, pitch, oversample=2)
    want = np.asarray(jps.synthesize_screen(13, jatm, 75, pitch,
                                            oversample=2))
    np.testing.assert_array_equal(got, want)


def test_screen_method_limits_match_jax():
    """Cholesky keeps JAX's N > 96 refusal; an unknown method raises; the
    subharmonic levels can be set apart from the config."""
    atm, jatm, pitch = _atm_pitch(64)
    with pytest.raises(ValueError, match="N<=96"):
        phase_screens.synthesize_screen(1, atm, 49, pitch, oversample=2,
                                        method="cholesky")
    with pytest.raises(ValueError, match="unknown screen method"):
        phase_screens.synthesize_screen(1, atm, 16, pitch, method="zonal")
    got = phase_screens.synthesize_screen(5, atm, 16, pitch, oversample=2,
                                          subharmonic_levels=0)
    np.testing.assert_array_equal(got, np.asarray(jps.synthesize_screen(
        5, jatm, 16, pitch, oversample=2, subharmonic_levels=0)))


@pytest.mark.parametrize("cover_steps,max_screen", [
    (None, 4096), (300, 4096), (2000, 200)])
def test_make_layers_cover_steps_identical_to_jax(cover_steps, max_screen):
    """cover_steps sizes the screens (capped by max_screen) as the JAX
    package does: the same screens and steps, bit for bit."""
    R = 32
    cfg, jcfg = reference_config(R), jconfig.reference_config(R)
    tel = dataclasses.replace(cfg.telescope, resolution=R)
    jtel = dataclasses.replace(jcfg.telescope, resolution=R)
    ours = phase_screens.make_layers(3, cfg.atmosphere, tel,
                                     cover_steps=cover_steps,
                                     max_screen=max_screen, device="cpu")
    theirs = jps.make_layers(3, jcfg.atmosphere, jtel,
                             cover_steps=cover_steps, max_screen=max_screen)
    np.testing.assert_array_equal(npy(ours.screens),
                                  np.asarray(theirs.screens))
    np.testing.assert_array_equal(npy(ours.step_px),
                                  np.asarray(theirs.step_px))
    if cover_steps == 300:
        d = float(npy(ours.step_px).max())
        assert ours.screens.shape[-1] - (R + 1) >= R + 2 + 300 * d
    if max_screen == 200:
        assert ours.screens.shape[-1] - (R + 1) <= R * int(np.ceil(200 / R))


def test_zernike_fit_and_synthesize_match_jax():
    basis = zernike.make_basis(5, 32, device="cpu")
    jbasis = jz.make_basis(5, 32)
    rng = np.random.default_rng(4)
    c = rng.normal(size=(2, 3, basis.n_modes)).astype(np.float32)
    ph = zernike.synthesize(basis, torch.as_tensor(c))
    assert ph.shape == (2, 3, 32, 32)
    np.testing.assert_allclose(npy(ph), np.asarray(jz.synthesize(
        jbasis, jnp.asarray(c))), rtol=1e-5, atol=1e-5)
    fit = zernike.fit(basis, ph)
    np.testing.assert_allclose(npy(fit), np.asarray(jz.fit(
        jbasis, jnp.asarray(npy(ph)))), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(npy(fit), c, atol=1e-4)


@pytest.mark.parametrize("preset", ["monotonic", "overshoot"])
def test_bezier_dm_through_pipeline_matches_jax(preset):
    """pipeline.build with influence="bezier_<preset>": the profile and
    the pupil maps bit-equal to JAX's, the system's modal influence within
    rtol 1e-5 of JAX's dm.build, unlike the Gaussian one's, and the loop
    runs on it."""
    R = 32
    influence = f"bezier_{preset}"
    prof, support = dm.bezier_profile(0.1, preset)
    jprof, jsupport = jdm.bezier_profile(0.1, preset)
    r = np.linspace(-3.0, 3.0, 61)
    np.testing.assert_array_equal(prof(r), jprof(r))
    assert support == jsupport
    cfg = reference_config(resolution=R)
    cfg = cfg.replace(dm=dataclasses.replace(cfg.dm, influence=influence),
                      sim=dataclasses.replace(cfg.sim, n_train=300,
                                              n_valid=50))
    jcfg = jconfig.reference_config(resolution=R)
    jdm_cfg = dataclasses.replace(jcfg.dm, influence=influence)
    pitch = cfg.dm.pixel_pitch * 512.0 / R
    np.testing.assert_array_equal(
        dm.influence_maps_pupil_bezier(cfg.dm, R, pitch, preset),
        jdm.influence_maps_pupil_bezier(jdm_cfg, R, pitch, preset))
    system = pipeline.build(cfg, "cpu")
    want = np.asarray(jdm.build(jdm_cfg, jz.make_basis(
        cfg.zernike.radial_order, R)).influence)
    got = npy(system.dm_model.influence)
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-6 * np.abs(want).max())
    gauss = npy(dm.build(dataclasses.replace(cfg.dm, influence="gaussian"),
                         system.basis, device="cpu").influence)
    assert np.abs(got - gauss).max() > 1e-3 * np.abs(gauss).max()
    out = pipeline.run_closed_loop(system, cfg, torch.Generator()
                                   .manual_seed(1), n_steps=5)
    assert all(bool(torch.isfinite(f).all()) for f in out)
    with pytest.raises(ValueError, match="unknown bezier preset"):
        dm.bezier_profile(0.1, "flat")
    with pytest.raises(ValueError, match="unknown DM influence"):
        dm.build(dataclasses.replace(cfg.dm, influence="zonal"),
                 system.basis, device="cpu")
