"""Zernike-coefficient statistics of Von Karman turbulence, the subset the
MMSE estimator's prior and the Karhunen-Loeve basis need (port of part of
``mpc_sensorlessao_tpu/ops/zernike_stats.py``).

Two complementary methods:

1. Grid propagation (coefficient_covariance & friends): covariance
   propagated through the SAME least-squares fit operator the pipeline
   uses -- exact w.r.t. the discrete basis, resolution-limited.
2. Spectral-domain analytics in Noll's Fourier formulation: the Von
   Karman phase PSD filtered by the closed-form Zernike aperture
   transforms, integrated by vectorized quadrature (the reference's OOMAO
   zernikeStats.m:152-203,359-430): the per-mode variance and the
   coefficient covariance.  The residual, temporal and angular analytics
   and the residue OTF are not ported yet (ROADMAP.md A.12).

Normalization: the framework's basis is UNNORMALIZED zernfun modes
(zernmodfit convention); Noll-normalized modes are N_j = sqrt((2 -
delta_m0)(n+1)) times larger, so framework coefficients are N_j times
Noll coefficients.  Every function returns framework-convention
statistics, comparable to the pipeline's fits.

Host numpy/scipy float64 setup code.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
from scipy import special as _sp

from ..utils.config import AtmosphereConfig
from . import phase_stats, zernike


@lru_cache(maxsize=8)
def _fit_geometry(radial_order: int, resolution: int):
    r, theta, mask = zernike._grid_polar(resolution)
    z_in = zernike.eval_points(radial_order, r[mask], theta[mask])
    w = np.linalg.pinv(z_in)                       # (K, P)
    return r, theta, mask, w


def _pupil_points(diameter: float, resolution: int, mask) -> np.ndarray:
    """Complex-coded [m] coordinates of the in-pupil grid points."""
    N1 = resolution - 1
    xs = (np.arange(resolution) * 2.0 - N1) / N1 * (diameter / 2.0)
    X, Y = np.meshgrid(xs, xs)
    return (X + 1j * Y)[mask]


def _piston_removed(C: np.ndarray) -> np.ndarray:
    """M C M' with M = I - J/P, the in-aperture mean-removal projector."""
    P = C.shape[0]
    M = np.eye(P) - np.full((P, P), 1.0 / P)
    return M @ C @ M.T


def coefficient_covariance(
    atm: AtmosphereConfig,
    diameter: float,
    radial_order: int,
    resolution: int = 48,
    piston_removed: bool = True,
) -> np.ndarray:
    """(K, K) covariance of fitted Zernike coefficients [rad^2].

    ``piston_removed`` applies the mean-removal projector inside the
    aperture before the fit (the pipeline's meanRmPhase convention).
    """
    _, _, mask, w = _fit_geometry(radial_order, resolution)
    pts = _pupil_points(diameter, resolution, mask)
    C = phase_stats.covariance_matrix(pts, pts, atm)
    if piston_removed:
        C = _piston_removed(C)
    return w @ C @ w.T


def coefficient_variances(atm, diameter, radial_order,
                          resolution: int = 48,
                          piston_removed: bool = True) -> np.ndarray:
    """Per-mode variances (the diagonal), in the framework's modified
    mode ordering."""
    return np.diag(coefficient_covariance(
        atm, diameter, radial_order, resolution, piston_removed)).copy()


def total_residual_variance(atm, diameter, radial_order,
                            resolution: int = 48) -> float:
    """Piston-removed phase variance NOT captured by the first K modes
    (the fitting-error floor for a modal corrector)."""
    r, theta, mask, w = _fit_geometry(radial_order, resolution)
    pts = _pupil_points(diameter, resolution, mask)
    C = _piston_removed(phase_stats.covariance_matrix(pts, pts, atm))
    P = pts.shape[0]
    z_in = zernike.eval_points(radial_order, r[mask], theta[mask])
    proj = z_in @ w                                # (P, P) fit projector
    resid = C - proj @ C - C @ proj.T + proj @ C @ proj.T
    return float(np.trace(resid) / P)


def _mode_nm(radial_order: int):
    modes = zernike.mode_indices(radial_order)
    n_arr = np.array([n for n, _ in modes])
    m_arr = np.array([m for _, m in modes])
    return n_arr, m_arr


def norm_factors(radial_order: int) -> np.ndarray:
    """N_j = sqrt((2 - delta_m0)(n+1)): Z_noll = N_j * Z_framework, so
    c_framework = N_j * c_noll (zernfun.m:175-177 'norm' flag without the
    1/sqrt(pi) area factor, which OOMAO's zernike class also omits)."""
    n_arr, m_arr = _mode_nm(radial_order)
    return np.sqrt((1.0 + (m_arr != 0)) * (n_arr + 1.0))


def sombrero(n: int, x: np.ndarray) -> np.ndarray:
    """J_n(x)/x with the x->0 limit (utilities.m:334-351)."""
    x = np.asarray(x, dtype=np.float64)
    out = np.empty_like(x)
    zero = x == 0.0
    out[zero] = 0.5 if n == 1 else 0.0
    xs = x[~zero]
    out[~zero] = _sp.jv(n, xs) / xs
    return out


_N_F = 1500    # radial quadrature nodes


@lru_cache(maxsize=32)
def _radial_grid(L0: float, diameter: float, n_max: int):
    """Log-spaced radial frequency grid + trapezoid weights for
    integrals of the form  integral g(f) f df  (weights include f).

    L0 = inf (Kolmogorov) has no outer-scale knee: the grid floor is set
    by the aperture alone."""
    if math.isfinite(L0):
        f_lo = min(1e-4 / L0, 1e-3 / diameter)
    else:
        f_lo = 1e-5 / diameter
    f_hi = 60.0 * (n_max + 2.0) / (math.pi * diameter)
    lf = np.linspace(math.log(f_lo), math.log(f_hi), _N_F)
    f = np.exp(lf)
    w = np.gradient(lf) * f * f          # f df = f^2 dln f
    return f, w


def variance_analytic(atm: AtmosphereConfig, diameter: float,
                      radial_order: int) -> np.ndarray:
    """(K,) per-mode coefficient variances [rad^2]
    (zernikeStats.m:152-203).

    sigma_j^2 = integral W(f) 8 pi (n+1) somb_{n+1}(pi f D)^2 f df
    (the azimuthal integral of |Q_j|^2 is mode-m independent).
    """
    n_arr, _ = _mode_nm(radial_order)
    f, w = _radial_grid(atm.L0, diameter, int(n_arr.max()))
    W = phase_stats.spectrum(f, atm)
    x = math.pi * diameter * f
    out = np.empty(len(n_arr))
    for k, n in enumerate(n_arr):
        filt = 8.0 * math.pi * (n + 1.0) * sombrero(int(n) + 1, x) ** 2
        out[k] = np.sum(W * filt * w)
    return out * norm_factors(radial_order) ** 2


def covariance_analytic(atm: AtmosphereConfig, diameter: float,
                        radial_order: int) -> np.ndarray:
    """(K, K) coefficient covariance [rad^2] (zernikeStats.m:359-430).

    Separable polar quadrature: C_ij = Re[(int A_i conj(A_j) dtheta) *
    (int W R_i R_j f df)] with A the azimuthal and R the radial factors
    of the aperture Fourier transforms.
    """
    n_arr, m_arr = _mode_nm(radial_order)
    f, w = _radial_grid(atm.L0, diameter, int(n_arr.max()))
    W = phase_stats.spectrum(f, atm)
    x = math.pi * diameter * f
    K = len(n_arr)
    orders = {int(n): sombrero(int(n) + 1, x) for n in set(n_arr.tolist())}
    Rmat = np.stack([2.0 * math.sqrt(n + 1.0) * orders[int(n)]
                     for n in n_arr])                       # (K, _N_F)
    radial = (Rmat * (W * w)) @ Rmat.T                      # (K, K)
    # azimuthal closed form: int_0^2pi gi conj(gj) cos(mi t + pi)
    # cos(mj t + pj) dt -- nonzero only for |mi| == |mj|, same trig type
    azim = np.zeros((K, K), dtype=np.complex128)
    for i in range(K):
        for j in range(K):
            mi, mj = m_arr[i], m_arr[j]
            if abs(mi) != abs(mj) or (mi < 0) != (mj < 0):
                continue
            ai, aj = abs(int(mi)), abs(int(mj))
            gi = ((-1.0) ** ((n_arr[i] + ai) / 2.0) * (1j ** ai)
                  * (math.sqrt(2.0) if ai else 1.0))
            gj = ((-1.0) ** ((n_arr[j] + aj) / 2.0) * (1j ** aj)
                  * (math.sqrt(2.0) if aj else 1.0))
            azim[i, j] = gi * np.conj(gj) * (math.pi if ai else 2 * math.pi)
    Nf = norm_factors(radial_order)
    return np.real(azim) * radial * np.outer(Nf, Nf)
