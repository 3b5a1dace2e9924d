"""Zernike basis, pupil, diversity PSF crops, estimator gains, DM
influence and the analytic Von Karman Zernike prior, float64.

Conventions the configuration fixes (the reference MATLAB pipeline's):
the Zernike grid is x = (-N:2:N)/N with [X, Y] = meshgrid(x), modes in
the modified ordering (per radial order n: m = -n, -n+2, ... < 0, then
n mod 2, ..., n), unnormalised (R_n^|m| times cos for m > 0, sin for
m < 0); the PSF pupil is the pin-hole disc of radius R/2 - 1 about
pixel R/2; a PSF crop is the central (2h+1)^2 window of
|fftshift(fft2(fftshift(pupil e^{i phase})))|^2 dx^4 AU, stacked over
the diversities (-a, 0, +a) x Z_4 and flattened column-major.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from scipy import special

F64 = torch.float64


def mode_list(radial_order: int) -> list[tuple[int, int]]:
    """(n, m) of every mode in the modified ordering."""
    out = []
    for n in range(radial_order + 1):
        out += [(n, m) for m in range(-n, 0, 2)]
        out += [(n, m) for m in range(n % 2, n + 1, 2)]
    return out


def zernike_grid(resolution: int, device):
    """(r, theta, mask) of the square grid x = (-N:2:N)/N."""
    N = resolution - 1
    x = (torch.arange(resolution, dtype=F64, device=device) * 2 - N) / N
    Y, X = torch.meshgrid(x, x, indexing="ij")     # X varies along columns
    r = torch.sqrt(X * X + Y * Y)
    return r, torch.atan2(Y, X), r <= 1.0 + 1e-12


def zernike_maps(radial_order: int, resolution: int, device):
    """(K, R, R) unnormalised modes, zero outside the unit disc, and the
    (R, R) bool disc."""
    r, th, mask = zernike_grid(resolution, device)
    maps = []
    for n, m in mode_list(radial_order):
        am = abs(m)
        rad = torch.zeros_like(r)
        for s in range((n - am) // 2 + 1):
            c = ((-1) ** s * math.factorial(n - s)
                 / (math.factorial(s) * math.factorial((n + am) // 2 - s)
                    * math.factorial((n - am) // 2 - s)))
            rad = rad + c * r ** (n - 2 * s)
        ang = (torch.cos(am * th) if m > 0 else
               torch.sin(am * th) if m < 0 else torch.ones_like(th))
        maps.append(torch.where(mask, rad * ang, 0.0))
    return torch.stack(maps), mask


def fit_operator(maps: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """(K, R*R): the least-squares Zernike coefficients of a phase map
    over the disc's pixels, as c = fit @ phase.ravel()."""
    K = maps.shape[0]
    Z = maps.reshape(K, -1)[:, mask.reshape(-1)].T              # (P, K)
    fit = torch.zeros((K, mask.numel()), dtype=F64, device=maps.device)
    fit[:, mask.reshape(-1)] = torch.linalg.solve(Z.T @ Z, Z.T)
    return fit


def pupil_disc(resolution: int, device) -> torch.Tensor:
    """The PSF pin-hole pupil: |(col - R/2, R/2 - row)| <= R/2 - 1."""
    ax = torch.arange(resolution, dtype=F64, device=device) - resolution // 2
    return ((ax[None, :] ** 2 + ax[:, None] ** 2)
            <= (resolution // 2 - 1) ** 2).to(F64)


def dft_matrix(resolution: int, half: int, device) -> torch.Tensor:
    """(w, R) complex128 rows of the centered DFT that give the crop:
    A[u, x] = exp(-2 pi i (u - c)(x - c) / R), c = R/2, |u - c| <= half."""
    c = resolution // 2
    u = torch.arange(-half, half + 1, dtype=F64, device=device)
    x = torch.arange(resolution, dtype=F64, device=device) - c
    return torch.exp(-2j * math.pi * torch.outer(u, x) / resolution)


def stack_column_major(c: torch.Tensor) -> torch.Tensor:
    """(..., n_div, w, w) crops -> (..., n_div w^2), each crop flattened
    column-major."""
    return c.transpose(-1, -2).reshape(*c.shape[:-3], -1)


class Optics:
    """The measurement model of one configuration."""

    def __init__(self, cfg: dict, device):
        est = cfg["estimator"]
        R = est["resolution"]
        self.R, self.half = R, est["crop_half"]
        self.w = 2 * self.half + 1
        self.maps, self.mask = zernike_maps(cfg["zernike"]["radial_order"],
                                            R, device)
        self.npix = float(self.mask.sum())
        self.fit = fit_operator(self.maps, self.mask)
        self.states = self.maps[1:]                             # no piston
        self.pupil = pupil_disc(R, device)
        dx = est["pixel_pitch"] * 512.0 / R
        self.scale = dx ** 4 * est["au"]
        # the diversity maps are float32 data: zd times the float32 Z_4
        z4 = self.maps[est["diversity_mode"]].float().double()
        a = est["diversity_amp"]
        self.div = torch.stack([(-a * z4).float(), 0 * z4,
                                (a * z4).float()]).double()     # (3, R, R)
        self.A = dft_matrix(R, self.half, device)

    def fields(self, phase: torch.Tensor) -> torch.Tensor:
        """(..., R, R) phases -> (..., 3, R, R) complex pupil fields."""
        return self.pupil * torch.exp(1j * (phase[..., None, :, :] + self.div))

    def linearise(self):
        """(b_s (p,), A_s (p, nx)) at zero aberration: y = |F|^2 s and
        dy/dx_k = 2 Re(conj(F) G_k) s with G_k the crop of i Z_k times
        the field."""
        f0 = self.fields(torch.zeros((self.R, self.R), dtype=F64,
                                     device=self.div.device))   # (3, R, R)
        F = self.A @ f0 @ self.A.T
        b_s = stack_column_major((F.real ** 2 + F.imag ** 2) * self.scale)
        cols = []
        for Zk in self.states:
            G = self.A @ (1j * Zk * f0) @ self.A.T
            cols.append(stack_column_major(
                2.0 * (F.real * G.real + F.imag * G.imag) * self.scale))
        return b_s, torch.stack(cols, dim=-1)


def noise_std(b_s: torch.Tensor, est: dict) -> float:
    """Measurement-noise std of the configured SNR and signal reference."""
    if est["snr_reference"] == "mean_abs":
        return float(b_s.abs().mean()) * 10.0 ** (-est["snr_db"] / 20.0)
    if est["snr_reference"] == "vector_power":
        return math.sqrt(float((b_s ** 2).mean())
                         * 10.0 ** (-est["snr_db"] / 10.0))
    raise ValueError(f"unknown snr_reference {est['snr_reference']!r}")


def ls_gain(A_s: torch.Tensor, tikhonov: float) -> torch.Tensor:
    """(nx, p) normal-equation least squares (A'A + t I)^-1 A'."""
    nx = A_s.shape[1]
    gram = A_s.T @ A_s + tikhonov * torch.eye(nx, dtype=F64,
                                              device=A_s.device)
    return torch.linalg.solve(gram, A_s.T)


def mmse_gain(A_s: torch.Tensor, prior: torch.Tensor,
              sigma: float) -> torch.Tensor:
    """(nx, p) linear MMSE gain C A'(A C A' + s2 I)^-1 with
    s2 = max(sigma^2, 1e-9 tr(A C A') / p), written in its equal
    nx-sized form (A'A + s2 C^-1)^-1 A'."""
    p = A_s.shape[0]
    s2 = max(sigma ** 2, 1e-9 * float(torch.einsum(
        "ik,kl,il->", A_s, prior, A_s)) / p)
    return torch.linalg.solve(A_s.T @ A_s + s2 * torch.linalg.inv(prior),
                              A_s.T)


def dm_influence(dm: dict, resolution: int, maps: torch.Tensor,
                 mask: torch.Tensor) -> torch.Tensor:
    """(nx, n_act) modal influence: the Gaussian actuator bumps of the
    DM grid, cropped to the pupil grid and least-squares projected on
    the full-square Zernike maps, piston row dropped."""
    dev = maps.device
    pp = dm["pixel_pitch"] * 512.0 / resolution
    n_dm = int(round(dm["half_width"] * 2 / pp))
    axis = (np.arange(n_dm) - n_dm / 2) * pp
    m1 = dm["n_act_side"]
    step = n_dm // (m1 - 1)
    idx = np.array([i * step for i in range(m1)])
    idx[-1] = n_dm - 1
    centers = axis[idx]
    pupil_axis = (np.arange(resolution) - resolution / 2) * pp
    lo = int(np.argmin(np.abs(axis - pupil_axis[0])))
    if int(np.argmin(np.abs(axis - pupil_axis[-1]))) - lo + 1 != resolution:
        raise ValueError("the DM grid does not span the pupil grid")
    xs = torch.as_tensor(axis[lo:lo + resolution], device=dev)
    ys = -xs
    cx = torch.as_tensor(centers, device=dev)
    pitch2 = (dm["diameter"] / (m1 - 1)) ** 2
    lnc = math.log(dm["coupling"])
    gx = torch.exp(lnc * (xs[None, :] - cx[:, None]) ** 2 / pitch2)  # (j, x)
    gy = torch.exp(lnc * (ys[None, :] + cx[:, None]) ** 2 / pitch2)  # (i, y)
    bumps = (gy[:, None, :, None] * gx[None, :, None, :]).reshape(
        m1 * m1, resolution * resolution)                       # k = i m1 + j
    Z = maps.reshape(maps.shape[0], -1).T                       # (R^2, K)
    B = torch.linalg.solve(Z.T @ Z, Z.T @ bumps.T)              # (K, n_act)
    return B[1:]


def zernike_prior(atm: dict, diameter: float, radial_order: int) -> np.ndarray:
    """(K, K) covariance [rad^2] of the unnormalised Zernike coefficients
    of Von Karman turbulence over the disc (Noll 1976):

      C_ij = 2 pi N_i N_j (-1)^((n_i + n_j)/2 - |m|) sqrt((n_i+1)(n_j+1))
             int_0^inf W(f) (2 J_{n_i+1}(x)/x) (2 J_{n_j+1}(x)/x) f df,

    x = pi D f, for modes of one |m| and one trigonometric type (else 0),
    N = sqrt((2 - delta_m0)(n + 1)) the unnormalised modes' scale.  The
    radial integral is 32-point Gauss-Legendre on panels of x up to 4096
    (the integrand falls as x^(-17/3)), at most 4 wide, so that every
    Bessel oscillation has nodes enough."""
    from .turbulence import spectrum
    edges = np.concatenate([[0.0, 0.25, 0.5, 1.0, 2.0],
                            np.arange(4.0, 4096.0 + 1, 4.0)])
    g, w = np.polynomial.legendre.leggauss(32)
    half = np.diff(edges)[:, None] / 2
    x = (edges[:-1, None] + (g + 1) * half).ravel()
    wx = (w * half).ravel()
    f = x / (math.pi * diameter)
    kernel = (spectrum(f, atm, float(sum(atm["fractional_r0"]))) * f
              / (math.pi * diameter) * wx)
    modes = mode_list(radial_order)
    bessel = {n: 2.0 * special.jv(n + 1, x) / x for n, _ in modes}
    K = len(modes)
    C = np.zeros((K, K))
    for i, (ni, mi) in enumerate(modes):
        for j, (nj, mj) in enumerate(modes):
            if abs(mi) != abs(mj) or (mi < 0) != (mj < 0):
                continue
            am = abs(mi)
            norm = (2.0 - (am == 0)) * math.sqrt((ni + 1) * (nj + 1))
            sign = (-1.0) ** ((ni + nj) // 2 - am)
            radial = float(np.sum(kernel * bessel[ni] * bessel[nj]))
            C[i, j] = (2.0 * math.pi * sign * math.sqrt((ni + 1) * (nj + 1))
                       * norm * radial)
    return C
