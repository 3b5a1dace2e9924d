"""Analytic telescope optics: diffraction OTF, Airy PSF, long exposures
(port of ``mpc_sensorlessao_tpu/ops/telescope_optics.py``, a numpy copy).

Equivalent of the reference's `telescope.otf` / `telescope.psf` analytics
(telescope.m:160-238) and `phaseStats.otf` (the exp(-D_phi/2)
long-exposure atmospheric transfer function): circular-aperture
autocorrelation with optional central obstruction, Airy intensity
profile, and the Hankel-transform radial PSF under turbulence.

Host-side float64 analytics (validation / calibration tools, same role
as ops/zernike_stats.py); all functions are vectorized numpy.
"""

from __future__ import annotations

import numpy as np
from scipy.special import j0, j1

from ..utils.config import AtmosphereConfig
from . import phase_stats


def _pup_autocorr(r, D):
    """Autocorrelation of a filled circular pupil of diameter D
    (telescope.m:181-188), un-normalized [m^2]."""
    r = np.abs(np.asarray(r, dtype=np.float64))
    out = np.zeros_like(r)
    idx = r <= D
    red = r[idx] / D
    out[idx] = D * D * (np.arccos(red) - red * np.sqrt(1 - red * red)) / 2
    return out


def _pup_crosscorr(r, R1, R2):
    """Cross-correlation of two concentric discs of radii R1, R2
    (telescope.m:190-204)."""
    r = np.abs(np.asarray(r, dtype=np.float64))
    out = np.zeros_like(r)
    out[r <= abs(R1 - R2)] = np.pi * min(R1, R2) ** 2
    idx = (r > abs(R1 - R2)) & (r < R1 + R2)
    rho = r[idx]
    red = (R1 * R1 - R2 * R2 + rho * rho) / (2 * rho) / R1
    acc = R1 * R1 * (np.arccos(red) - red * np.sqrt(1 - red * red))
    red = (R2 * R2 - R1 * R1 + rho * rho) / (2 * rho) / R2
    acc = acc + R2 * R2 * (np.arccos(red) - red * np.sqrt(1 - red * red))
    out[idx] = out[idx] + acc
    return out


def diffraction_otf(r, D: float, obstruction: float = 0.0):
    """Telescope OTF at pupil-plane separation r [m] (telescope.m:160-179),
    normalized to 1 at r=0; optional central obstruction ratio."""
    if obstruction:
        num = (_pup_autocorr(r, D) + _pup_autocorr(r, obstruction * D)
               - 2.0 * _pup_crosscorr(r, D / 2, obstruction * D / 2))
    else:
        num = _pup_autocorr(r, D)
    return num / (np.pi * D * D * (1 - obstruction ** 2) / 4)


def atmospheric_otf(r, atm: AtmosphereConfig):
    """Long-exposure atmospheric OTF exp(-D_phi(r)/2) (phaseStats.otf)."""
    return np.exp(-0.5 * phase_stats.structure_function(r, atm, np))


def long_exposure_otf(r, D: float, atm: AtmosphereConfig,
                      obstruction: float = 0.0):
    """Combined telescope x atmosphere OTF (telescope.m:176-178)."""
    return diffraction_otf(r, D, obstruction) * atmospheric_otf(r, atm)


def airy_psf(f, D: float, obstruction: float = 0.0):
    """Diffraction-limited PSF at angular frequency f [1/rad... the
    reference's f has units of D^-1 conjugate] (telescope.m:208-231,
    no-atmosphere branch): |2 J1(pi D f)/(pi D f)|^2-style profile,
    normalized by the pupil surface."""
    f = np.asarray(f, dtype=np.float64)
    surface = np.pi * D ** 2 / 4
    out = np.full(f.shape, surface * (1 - obstruction ** 2))
    idx = f != 0
    u = np.pi * D * f[idx]
    val = surface * 2 * j1(u) / u
    if obstruction > 0:
        uo = np.pi * D * obstruction * f[idx]
        val = val - surface * obstruction ** 2 * 2 * j1(uo) / uo
    out[idx] = val
    return np.abs(out) ** 2 / (np.pi * D ** 2 * (1 - obstruction ** 2) / 4)


def psf_radial(f, D: float, atm: AtmosphereConfig | None = None,
               obstruction: float = 0.0, n_quad: int = 2048):
    """Radial long-exposure PSF via the Hankel transform of the OTF
    (telescope.m:212-215): psf(f) = 2 pi Int_0^D x J0(2 pi x f) OTF(x) dx.
    Plain trapezoid quadrature (the integrand is smooth and compactly
    supported)."""
    f = np.atleast_1d(np.asarray(f, dtype=np.float64))
    x = np.linspace(0.0, D, n_quad)
    otf = diffraction_otf(x, D, obstruction)
    if atm is not None:
        otf = otf * atmospheric_otf(x, atm)
    integrand = x[None, :] * j0(2 * np.pi * x[None, :] * f[:, None]) \
        * otf[None, :]
    return 2 * np.pi * np.trapezoid(integrand, x, axis=1)


def strehl_ratio(D: float, atm: AtmosphereConfig,
                 obstruction: float = 0.0) -> float:
    """Long-exposure Strehl = psf(0)_atm / psf(0)_diffraction, i.e. the
    OTF volume ratio (the exact version of the Marechal approximation)."""
    x = np.linspace(0.0, D, 4096)
    w = x * diffraction_otf(x, D, obstruction)
    return float(np.trapezoid(w * atmospheric_otf(x, atm), x)
                 / np.trapezoid(w, x))
