"""Zernike-coefficient statistics of Von Karman turbulence (port of
``mpc_sensorlessao_tpu/ops/zernike_stats.py``; OOMAO zernikeStats.m).

Two complementary methods:

1. Grid propagation (coefficient_covariance & friends): covariance
   propagated through the SAME least-squares fit operator the pipeline
   uses -- exact w.r.t. the discrete basis, resolution-limited; the
   residue* family after J-mode correction rests on it.
2. Spectral-domain analytics in Noll's Fourier formulation: the Von
   Karman phase PSD filtered by the closed-form Zernike aperture
   transforms, integrated by vectorized quadrature: per-mode variance
   and covariance (zernikeStats.m:152-203,359-430), residual variance
   after J-mode correction (:539-563), temporal spectra under frozen
   flow (:23-55), angular covariance and anisoplanatism
   (:566-779,1294-1330), closed-loop and tip-tilt analytics
   (:111-142,309-358,1220-1347).

Normalization: the framework's basis is UNNORMALIZED zernfun modes
(zernmodfit convention); Noll-normalized modes are N_j = sqrt((2 -
delta_m0)(n+1)) times larger, so framework coefficients are N_j times
Noll coefficients.  Every analytic function takes ``normalized`` --
False (default) returns framework-convention statistics directly
comparable to the pipeline's fits.

Host numpy/scipy float64 code, the JAX package's arithmetic line for line.
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


def zernike_fourier(n_arr, m_arr, f, theta, diameter: float) -> np.ndarray:
    """Fourier transform of Noll-normalized Zernike modes over the
    diameter-D disc (zernike.m:368-385).

    Signed-m convention (the framework's): m > 0 -> cos(|m| theta),
    m < 0 -> sin(|m| theta) (Noll's even/odd-j phase p maps to 0 / -pi/2).
    f, theta broadcast; returns complex (K, *f.shape).
    """
    f = np.asarray(f, dtype=np.float64)
    theta = np.asarray(theta, dtype=np.float64)
    out = np.empty((len(n_arr),) + f.shape, dtype=np.complex128)
    x = math.pi * diameter * f
    # the Bessel factor once per radial order on the distinct x values (a
    # polar grid repeats each radius n_theta times): the same jv inputs,
    # so the same values as evaluating it per mode on the full grid
    xu, inv = np.unique(x, return_inverse=True)
    somb = {int(n): sombrero(int(n) + 1, xu)[inv].reshape(x.shape)
            for n in set(np.asarray(n_arr).tolist())}
    for k, (n, m) in enumerate(zip(n_arr, m_arr)):
        am = abs(int(m))
        krkr = am != 0
        g = ((-1.0) ** ((n + am) / 2.0) * (1j ** am)
             * (math.sqrt(2.0) if krkr else 1.0))
        p = -math.pi / 2.0 if m < 0 else 0.0
        out[k] = (2.0 * math.sqrt(n + 1.0) * somb[int(n)]
                  * g * np.cos(am * theta + p))
    return out


@lru_cache(maxsize=32)
def _radial_grid(L0: float, diameter: float, n_max: int, n_f: int = 1500):
    """Log-spaced radial frequency grid + trapezoid weights for
    integrals of the form  integral g(f) f df  (weights include f)."""
    # L0 = inf (Kolmogorov) is a supported config: no outer-scale knee,
    # grid floor set by the aperture alone (filtered integrands converge;
    # the raw piston-included variance is genuinely infinite there and
    # comes out grid-truncated -- use residual_variance for Kolmogorov)
    if math.isfinite(L0):
        f_lo = min(1e-4 / L0, 1e-3 / diameter)
    else:
        f_lo = 1e-5 / diameter
    f_hi = 60.0 * (n_max + 2.0) / (math.pi * diameter)
    lf = np.linspace(math.log(f_lo), math.log(f_hi), n_f)
    f = np.exp(lf)
    w = np.gradient(lf) * f * f          # f df = f^2 dln f
    return f, w


def variance_analytic(atm: AtmosphereConfig, diameter: float,
                      radial_order: int,
                      normalized: bool = False) -> np.ndarray:
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
    if not normalized:
        out = out * norm_factors(radial_order) ** 2
    return out


def covariance_analytic(atm: AtmosphereConfig, diameter: float,
                        radial_order: int,
                        normalized: bool = False) -> np.ndarray:
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
                     for n in n_arr])                       # (K, n_f)
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
    C = np.real(azim) * radial
    if not normalized:
        Nf = norm_factors(radial_order)
        C = C * np.outer(Nf, Nf)
    return C


def residual_variance(j_last: int, atm: AtmosphereConfig,
                      diameter: float) -> float:
    """Piston-removed phase variance left after perfectly correcting the
    first ``j_last`` modes (Noll ordering count; zernikeStats.m:539-563).

    Filter form  Delta_J = integral 2 pi f W(f) [1 - sum_j F_j(f)] df
    with F_j = 4 (n_j+1) somb_{n_j+1}^2 -- converges for Kolmogorov-like
    L0 (unlike variance-minus-sum, which needs finite total variance).
    Noll table check: Delta_1 ~= 1.0299 (D/r0)^{5/3} as L0 -> inf.
    """
    # mode list in Noll-equivalent order: (n, then |m|) -- the modified
    # ordering differs only within an n-block, and F_j depends on n only,
    # so any ordering consistent in counts per order works.
    order = 0
    ns = []
    while len(ns) < j_last:
        ns.extend([order] * (order + 1))
        order += 1
    ns = np.array(ns[:j_last])
    n_max = int(ns.max())
    f, w = _radial_grid(atm.L0, diameter, max(n_max, 3), n_f=4000)
    W = phase_stats.spectrum(f, atm)
    x = math.pi * diameter * f
    filt = np.zeros_like(f)
    for n in ns:
        filt += 4.0 * (n + 1.0) * sombrero(int(n) + 1, x) ** 2
    return float(np.sum(2.0 * math.pi * f * W * (1.0 - filt) * w / f))


def temporal_spectrum_analytic(nu, atm: AtmosphereConfig, diameter: float,
                               radial_order: int,
                               normalized: bool = False,
                               n_t: int = 6001) -> np.ndarray:
    """Two-sided temporal PSD of Zernike coefficients under frozen flow
    [rad^2/Hz], shape (len(nu), K)  (zernikeStats.m:23-55).

    Per layer with wind (v, d):  S_j(nu) = (1/v) integral dt
    W(|f|) |Q_j(|f|, ang(f))|^2  along the line f = (nu/v) e_d + t e_perp
    (the reference's quadgk over f_y, rotated to handle any wind
    direction without the vx/vy special cases).
    Sum rule: integral_{-inf}^{inf} S_j dnu = sigma_j^2.
    """
    nu = np.atleast_1d(np.asarray(nu, dtype=np.float64))
    n_arr, m_arr = _mode_nm(radial_order)
    n_max = int(n_arr.max())
    K = len(n_arr)
    out = np.zeros((len(nu), K))
    t_max = 40.0 * (n_max + 2.0) / (math.pi * diameter)
    t = np.linspace(-t_max, t_max, n_t)
    dt = t[1] - t[0]
    for il in range(atm.n_layers):
        slab = atm.layer(il)
        v = slab.wind_speeds[0]
        d = slab.wind_directions[0]
        if v <= 0:
            continue
        f_par = nu[:, None] / v                             # (n_nu, 1)
        fx = f_par * math.cos(d) - t[None, :] * math.sin(d)
        fy = f_par * math.sin(d) + t[None, :] * math.cos(d)
        fr = np.hypot(fx, fy)
        th = np.arctan2(fy, fx)
        W = phase_stats.spectrum(fr, slab)
        x = math.pi * diameter * fr
        somb = {int(n): sombrero(int(n) + 1, x)
                for n in set(n_arr.tolist())}
        for k in range(K):
            n, m = int(n_arr[k]), int(m_arr[k])
            am = abs(m)
            p = -math.pi / 2.0 if m < 0 else 0.0
            q2 = (4.0 * (n + 1.0) * somb[n] ** 2
                  * (2.0 if am else 1.0) * np.cos(am * th + p) ** 2)
            out[:, k] += np.sum(W * q2, axis=1) * dt / v
    if not normalized:
        out = out * norm_factors(radial_order) ** 2
    return out


def angular_covariance_analytic(atm: AtmosphereConfig, diameter: float,
                                radial_order: int, theta: float,
                                azimuth: float = 0.0,
                                normalized: bool = False,
                                n_f: int = 700,
                                n_theta: int = 256) -> np.ndarray:
    """(K, K) covariance between coefficients of two directions separated
    by field angle ``theta`` [rad] at ``azimuth`` (zernikeStats.m:566-779).

    Per layer, the sources' footprints are displaced by s = h tan(theta),
    adding exp(i 2 pi f . s) inside the quadrature.  theta=0 reduces to
    covariance_analytic.
    """
    n_arr, m_arr = _mode_nm(radial_order)
    n_max = int(n_arr.max())
    K = len(n_arr)
    f, w = _radial_grid(atm.L0, diameter, n_max, n_f)
    th = np.linspace(0.0, 2.0 * math.pi, n_theta, endpoint=False)
    dth = 2.0 * math.pi / n_theta
    Q = zernike_fourier(n_arr, m_arr, f[None, :].repeat(n_theta, 0).T,
                        np.broadcast_to(th, (n_f, n_theta)), diameter)
    # (K, n_f, n_theta); azimuthal factors of Q_i Q_j* -> batched einsum
    C = np.zeros((K, K))
    for il in range(atm.n_layers):
        slab = atm.layer(il)
        s = slab.altitudes[0] * math.tan(theta)
        W = phase_stats.spectrum(f, slab)
        E = np.exp(1j * 2.0 * math.pi * np.outer(f * s, np.cos(th - azimuth)))
        ker = (W * w)[:, None] * E                         # (n_f, n_theta)
        # C_ij(s) = <a_i(theta+s) a_j(theta)> = Re int W conj(Q_i) Q_j
        # e^{i 2 pi f . s}  (a_i(c) = int phihat conj(Q_i) e^{i2pif.c}):
        # conjugating Q_i, not Q_j -- the swapped form silently returns
        # the TRANSPOSE and breaks tomography off-diagonal blocks
        C += np.real(np.einsum("ift,ft,jft->ij", np.conj(Q), ker, Q,
                               optimize=True)) * dth
    if not normalized:
        Nf = norm_factors(radial_order)
        C = C * np.outer(Nf, Nf)
    return C


def anisoplanatism_variance(atm: AtmosphereConfig, diameter: float,
                            radial_order: int, theta: float) -> float:
    """Total Zernike-mode anisoplanatism error [rad^2] at field angle
    theta (zernikeStats.m:1294-1330): sum_j 2 (sigma_j^2 - cov_jj(theta))
    over non-piston modes, in the Noll-normalized basis (so per-mode
    terms are aperture phase variances and add directly)."""
    var = variance_analytic(atm, diameter, radial_order, normalized=True)
    cov = np.diag(angular_covariance_analytic(
        atm, diameter, radial_order, theta, normalized=True))
    return float(np.sum(2.0 * (var[1:] - cov[1:])))


# ---------------------------------------------------------------------------
# Residual-phase spatial statistics after J-mode correction
# (zernikeStats.m residue* family, :1783-2045)
# ---------------------------------------------------------------------------

@lru_cache(maxsize=4)
def _residual_covariance_grid(atm_key, diameter: float, radial_order: int,
                              resolution: int):
    """(P, P) covariance of the piston-removed phase with the first
    `radial_order` orders perfectly removed, on the pupil grid --
    C_res = M C_phi M' with M = (I - Z W)(I - 11'/P).

    The reference computes the same object pointwise with per-pair
    Bessel quadrature (residueVarianceMap/StructureFunction,
    zernikeStats.m:1783-1986); the grid projector is exact w.r.t. the
    framework's discrete basis and turns the whole family into dense
    matrix algebra.  atm_key = the AtmosphereConfig (hashable dataclass).
    """
    atm = atm_key
    r, theta, mask, w = _fit_geometry(radial_order, resolution)
    pts = _pupil_points(diameter, resolution, mask)
    C = phase_stats.covariance_matrix(pts, pts, atm)
    P = pts.shape[0]
    Mp = np.eye(P) - np.full((P, P), 1.0 / P)
    z_in = zernike.eval_points(radial_order, r[mask], theta[mask])
    proj = np.eye(P) - z_in @ w
    M = proj @ Mp
    return M @ C @ M.T, pts, mask


def residue_variance_map(atm: AtmosphereConfig, diameter: float,
                         radial_order: int,
                         resolution: int = 32) -> np.ndarray:
    """(R, R) map of residual phase variance after removing all modes
    through `radial_order` (zernikeStats.m:1783-1871 residueVarianceMap);
    NaN outside the pupil."""
    C_res, pts, mask = _residual_covariance_grid(
        atm, diameter, radial_order, resolution)
    out = np.full((resolution, resolution), np.nan)
    out[mask] = np.diag(C_res)
    return out


def residue_structure_function(atm: AtmosphereConfig, diameter: float,
                               radial_order: int, i, j,
                               resolution: int = 32) -> np.ndarray:
    """D_res between pupil-grid point sets i, j (flat indices into the
    masked point list)  (zernikeStats.m:1872-1986)."""
    C_res, _, _ = _residual_covariance_grid(
        atm, diameter, radial_order, resolution)
    i = np.asarray(i)
    j = np.asarray(j)
    return (C_res[i, i] + C_res[j, j] - 2.0 * C_res[i, j])


def residue_otf(atm: AtmosphereConfig, diameter: float, radial_order: int,
                resolution: int = 32) -> np.ndarray:
    """(2R-1, 2R-1) long-exposure residual OTF
    exp(-D_res/2) averaged over the pupil overlap at every lattice shift
    (zernikeStats.m:1988-2019 residueOtf), normalized to 1 at zero
    separation scaling aside: out[s] = sum_pairs exp(-D/2) (the
    diffraction-limited OTF is the pair COUNT, so Strehl ratios divide
    them)."""
    C_res, pts, mask = _residual_covariance_grid(
        atm, diameter, radial_order, resolution)
    R = resolution
    idx = np.full((R, R), -1, dtype=np.int64)
    idx[mask] = np.arange(mask.sum())
    v = np.diag(C_res)
    otf = np.zeros((2 * R - 1, 2 * R - 1))
    for dy in range(-(R - 1), R):
        for dx in range(-(R - 1), R):
            a = idx[max(0, dy):R + min(0, dy), max(0, dx):R + min(0, dx)]
            b = idx[max(0, -dy):R + min(0, -dy),
                    max(0, -dx):R + min(0, -dx)]
            sel = (a >= 0) & (b >= 0)
            ii = a[sel]
            jj = b[sel]
            if ii.size == 0:
                continue
            D = v[ii] + v[jj] - 2.0 * C_res[ii, jj]
            otf[dy + R - 1, dx + R - 1] = np.exp(-0.5 * D).sum()
    return otf


def residue_strehl_ratio(atm: AtmosphereConfig, diameter: float,
                         radial_order: int,
                         resolution: int = 32) -> float:
    """Long-exposure Strehl after perfect J-mode correction: OTF-volume
    ratio sum(OTF_res)/sum(OTF_DL)  (zernikeStats.m:2021-2031)."""
    C_res, pts, mask = _residual_covariance_grid(
        atm, diameter, radial_order, resolution)
    otf = residue_otf(atm, diameter, radial_order, resolution)
    # diffraction-limited OTF on the same lattice = overlap pair counts
    m = mask.astype(np.float64)
    n = 2 * resolution
    auto = np.real(np.fft.ifft2(np.abs(np.fft.fft2(m, (n, n))) ** 2))
    counts = np.fft.fftshift(auto)[1:, 1:]
    return float(otf.sum() / counts.sum())


def residue_entrapped_energy(atm: AtmosphereConfig, diameter: float,
                             radial_order: int, e_half_size_ld: float,
                             resolution: int = 32) -> float:
    """Fraction of long-exposure energy inside a square(ish) window of
    half-size ``e_half_size_ld`` [lambda/D units]
    (zernikeStats.m:2033-2044): the Airy-window overlap integral
    2 somb(1, 2 pi e rho) weighting of the residual OTF, normalized by
    the same weighting of the diffraction-limited OTF at e -> inf ==
    total flux; here we return the ratio vs the DL system's entrapped
    energy so 1.0 = diffraction limited."""
    R = resolution
    otf = residue_otf(atm, diameter, radial_order, resolution)
    C_res, pts, mask = _residual_covariance_grid(
        atm, diameter, radial_order, resolution)
    m = mask.astype(np.float64)
    n = 2 * R
    auto = np.real(np.fft.ifft2(np.abs(np.fft.fft2(m, (n, n))) ** 2))
    counts = np.fft.fftshift(auto)[1:, 1:]
    d = np.arange(-(R - 1), R) * (diameter / (R - 1))
    dx, dy = np.meshgrid(d, d)
    rho = np.hypot(dx, dy) / diameter          # in D units
    x = 2.0 * math.pi * e_half_size_ld * rho
    somb = np.where(x > 0, 2.0 * _sp.jv(1, np.where(x > 0, x, 1.0))
                    / np.where(x > 0, x, 1.0), 1.0)
    num = float((otf * somb).sum())
    den = float((counts * somb).sum())
    return num / den


# ---------------------------------------------------------------------------
# Closed-loop / tip-tilt analytics (zernikeStats.m:111-142,309-358,1220-1347)
# ---------------------------------------------------------------------------

def closed_loop_variance(atm: AtmosphereConfig, diameter: float,
                         radial_order: int, T: float, tau: float,
                         gain: float, n_nu: int = 400) -> np.ndarray:
    """(K,) residual coefficient variances under a gain/delay integrator
    loop:  2 integral S_j(nu) |E(nu)|^2 dnu  with the reference's
    rejection TF E = 1/(1+G), G = ((1-e^-sT)/sT)^2 e^-s tau g/(1-e^-sT)
    (zernikeStats.m:111-142 closedLoopVariance)."""
    nu = np.logspace(-2, math.log10(2.0 / T), n_nu)
    s = 2j * math.pi * nu
    zoh = (1.0 - np.exp(-s * T)) / (s * T)
    G = zoh ** 2 * np.exp(-tau * s) * gain / (1.0 - np.exp(-s * T))
    E2 = np.abs(1.0 / (1.0 + G)) ** 2
    S = temporal_spectrum_analytic(nu, atm, diameter, radial_order)
    return 2.0 * np.trapezoid(S * E2[:, None], nu, axis=0)


def rms_arcsec(atm: AtmosphereConfig, diameter: float,
               variance_rad2) -> np.ndarray:
    """Zernike tilt-coefficient rms -> image motion [arcsec]
    (zernikeStats.m:327-345: radian2arcsec (lambda/2pi) sqrt(var) 4/D)."""
    return (phase_stats.RADIAN2ARCSEC * (0.5 * atm.wavelength / math.pi)
            * np.sqrt(np.asarray(variance_rad2)) * 4.0 / diameter)


def anisokinetism_variance(atm: AtmosphereConfig, diameter: float,
                           theta: float) -> float:
    """Tip-tilt anisoplanatism variance [rad^2] at field angle theta
    (zernikeStats.m:1220-1293): the order-1 modes' contribution of the
    angular decorrelation, 2 sum_tt (var - cov(theta))."""
    var = variance_analytic(atm, diameter, 1, normalized=True)
    cov = np.diag(angular_covariance_analytic(atm, diameter, 1, theta,
                                              normalized=True))
    return float(np.sum(2.0 * (var[1:3] - cov[1:3])))


def anisokinetism_angle_arcsec(atm: AtmosphereConfig, diameter: float,
                               threshold_rad2: float = 1.0) -> float:
    """Field angle where the tip-tilt anisoplanatism reaches
    ``threshold_rad2`` (zernikeStats.m:1331-1347 anisokinetismAngle, which
    solves for 1 rad^2), by bisection on the analytic curve."""
    lo, hi = 1e-8, 1e-2
    for _ in range(60):
        mid = math.sqrt(lo * hi)
        if anisokinetism_variance(atm, diameter, mid) < threshold_rad2:
            lo = mid
        else:
            hi = mid
    return math.sqrt(lo * hi) * phase_stats.RADIAN2ARCSEC


def coefficient_angular_covariance(atm: AtmosphereConfig, diameter: float,
                                   radial_order: int, dtheta=(0.0, 0.0),
                                   lag: float = 0.0,
                                   normalized: bool = False,
                                   n_f: int = 700,
                                   n_theta: int = 256) -> np.ndarray:
    """(K, K) covariance between Zernike coefficients seen in two
    directions separated by the VECTOR ``dtheta`` [rad] and two instants
    separated by ``lag`` [s] under frozen flow -- the general pairwise
    kernel behind tomography (linearMMSE.m 'modal', zernikeStats.m
    angularCovariance:566-779 + temporalAngularCovariance:920-1062).

    Per layer the footprints are displaced by  s_l = h_l dtheta +
    v_l lag (cos, sin)(wind_dir);  dtheta=(0,0), lag=0 reduces to
    covariance_analytic.
    """
    n_arr, m_arr = _mode_nm(radial_order)
    n_max = int(n_arr.max())
    K = len(n_arr)
    f, w = _radial_grid(atm.L0, diameter, n_max, n_f)
    th = np.linspace(0.0, 2.0 * math.pi, n_theta, endpoint=False)
    dth = 2.0 * math.pi / n_theta
    Q = zernike_fourier(n_arr, m_arr, f[None, :].repeat(n_theta, 0).T,
                        np.broadcast_to(th, (n_f, n_theta)), diameter)
    C = np.zeros((K, K))
    for il in range(atm.n_layers):
        slab = atm.layer(il)
        h = slab.altitudes[0]
        v = slab.wind_speeds[0]
        d = slab.wind_directions[0]
        sx = h * math.tan(dtheta[0]) + v * lag * math.cos(d)
        sy = h * math.tan(dtheta[1]) + v * lag * math.sin(d)
        s = math.hypot(sx, sy)
        alpha = math.atan2(sy, sx)
        W = phase_stats.spectrum(f, slab)
        E = np.exp(1j * 2.0 * math.pi
                   * np.outer(f * s, np.cos(th - alpha)))
        ker = (W * w)[:, None] * E
        # conj on the FIRST factor: see angular_covariance_analytic
        C += np.real(np.einsum("ift,ft,jft->ij", np.conj(Q), ker, Q,
                               optimize=True)) * dth
    if not normalized:
        Nf = norm_factors(radial_order)
        C = C * np.outer(Nf, Nf)
    return C
