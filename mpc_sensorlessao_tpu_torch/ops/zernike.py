"""Zernike modal engine (port of ``mpc_sensorlessao_tpu/ops/zernike.py``).

* the mode table uses the reference's *modified* ordering -- per radial
  order n, azimuthal numbers m = (-n:2:-1) then fliplr(n:-2:0)
  (reference: zernmodfit.m:195-198), so mode 0 is piston and mode 4 is
  defocus (the diversity mode, MATLAB 1-based idx2=5, README.md:393);
* the basis is generated on the grid x=(-N:2:N)/N, [X,Y]=meshgrid(x)
  (reference: README.md:78-84,246-253);
* everything is precomputed once on the host in numpy float64 and moved
  to the requested device as float32.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import lru_cache
from typing import Tuple

import numpy as np
import torch

# steps per batched Zernike fit of an open-loop rollout (the periodic
# screens' closed_loop.turbulence_rollout, the flow's edge_flow.rollout)
ROLLOUT_CHUNK = 32


@lru_cache(maxsize=None)
def mode_indices(radial_order: int) -> Tuple[Tuple[int, int], ...]:
    """(n, m) pairs in the reference's modified ordering.

    Per n: m = [-n, -n+2, ..., -2 or -1] then [n%2, ..., n-2, n]
    (reference: zernmodfit.m:195-198).
    """
    modes = []
    for n in range(radial_order + 1):
        ms = list(range(-n, 0, 2)) + list(range(n % 2, n + 1, 2))
        modes.extend((n, m) for m in ms)
    return tuple(modes)


def n_modes(radial_order: int) -> int:
    return (radial_order + 1) * (radial_order + 2) // 2


@lru_cache(maxsize=None)
def radial_coeff_table(radial_order: int) -> np.ndarray:
    """Dense (n_modes, radial_order+1) table C with
    R_n^{|m|}(r) = sum_p C[k, p] r^p  (reference: zernfun.m:161-173)."""
    modes = mode_indices(radial_order)
    table = np.zeros((len(modes), radial_order + 1), dtype=np.float64)
    for k, (n, m) in enumerate(modes):
        am = abs(m)
        for s in range((n - am) // 2 + 1):
            p = n - 2 * s
            table[k, p] = (
                (-1) ** s
                * math.factorial(n - s)
                / (
                    math.factorial(s)
                    * math.factorial((n + am) // 2 - s)
                    * math.factorial((n - am) // 2 - s)
                )
            )
    return table


def eval_points(radial_order: int, r: np.ndarray,
                theta: np.ndarray) -> np.ndarray:
    """Evaluate all modes at polar points -> (len(r), n_modes), float64.

    Azimuthal convention matches zernfun.m:184-192: m>0 -> cos(|m| theta),
    m<0 -> sin(|m| theta); unnormalized (zernmodfit.m:205).
    """
    modes = mode_indices(radial_order)
    coeff = radial_coeff_table(radial_order)
    r = np.asarray(r, dtype=np.float64).ravel()
    theta = np.asarray(theta, dtype=np.float64).ravel()
    powers = np.arange(radial_order + 1, dtype=np.float64)
    radial = (r[:, None] ** powers[None, :]) @ coeff.T      # (P, K)
    m_arr = np.array([m for _, m in modes])
    ang = theta[:, None] * np.abs(m_arr)[None, :]
    azim = np.where(m_arr[None, :] > 0, np.cos(ang),
                    np.where(m_arr[None, :] < 0, np.sin(ang), 1.0))
    return radial * azim


@dataclass(frozen=True)
class ZernikeBasis:
    """Precomputed modal basis on a square grid (tensors on one device).

      stack:     (K, R, R) float32 mode maps, zero outside the unit disc.
      mask:      (R, R) bool pupil membership r<=1.
      fit_full:  (K, R*R) float32: coeffs = fit_full @ phase.ravel(), the
                 least-squares decomposition z\\data of zernmodfit.m:209.
      gram:      (K, K) mean_pupil(Z_j Z_k) on the discrete grid.
      mode_mean: (K,) mean_pupil(Z_k).
    """

    stack: torch.Tensor
    mask: torch.Tensor
    fit_full: torch.Tensor
    radial_order: int
    gram: torch.Tensor
    mode_mean: torch.Tensor

    @property
    def n_modes(self) -> int:
        return self.stack.shape[0]

    @property
    def resolution(self) -> int:
        return self.stack.shape[1]


@lru_cache(maxsize=8)
def _grid_polar(resolution: int):
    """Reference grid: x=(-N:2:N)/N, [X,Y]=meshgrid(x), cart2pol
    (reference: README.md:78-84). X varies along columns, Y along rows."""
    N = resolution - 1
    x = (np.arange(resolution) * 2.0 - N) / N
    X, Y = np.meshgrid(x, x)
    r = np.hypot(X, Y)
    theta = np.arctan2(Y, X)
    mask = r <= 1.0 + 1e-12
    return r, theta, mask


def make_basis(radial_order: int, resolution: int,
               device: torch.device | str = "cuda") -> ZernikeBasis:
    """Build the basis stack + fit operator (host float64 precompute)."""
    r, theta, mask = _grid_polar(resolution)
    P = int(mask.sum())
    z_in = eval_points(radial_order, r[mask], theta[mask])      # (P, K)
    K = z_in.shape[1]

    stack = np.zeros((K, resolution, resolution), dtype=np.float64)
    stack[:, mask] = z_in.T

    # least-squares fit operator: c = pinv(Z) data  (zernmodfit.m:209)
    fit_full = np.zeros((K, resolution * resolution), dtype=np.float64)
    fit_full[:, mask.ravel()] = np.linalg.pinv(z_in)

    def f32(a):
        return torch.as_tensor(a, dtype=torch.float32, device=device)

    return ZernikeBasis(
        stack=f32(stack),
        mask=torch.as_tensor(mask, device=device),
        fit_full=f32(fit_full),
        radial_order=radial_order,
        gram=f32(z_in.T @ z_in / P),
        mode_mean=f32(z_in.sum(axis=0) / P),
    )


def fit(basis: ZernikeBasis, phase: torch.Tensor) -> torch.Tensor:
    """Zernike decomposition of phase map(s): (..., R, R) -> (..., K).

    zernmodfit's c = z\\data (zernmodfit.m:209) as one batched matmul.
    """
    R = basis.resolution
    flat = phase.reshape(*phase.shape[:-2], R * R)
    return flat @ basis.fit_full.T


def synthesize(basis: ZernikeBasis, coeffs: torch.Tensor) -> torch.Tensor:
    """Weighted mode sum: coeffs (..., K) -> phase (..., R, R), the
    reference's correction synthesis loop (README.md:596-601) as one
    contraction."""
    R = basis.resolution
    flat = coeffs @ basis.stack.reshape(basis.n_modes, R * R)
    return flat.reshape(*coeffs.shape[:-1], R, R)


def piston_removed_phase_masked(phase: torch.Tensor, mask: torch.Tensor,
                                mask_npix) -> torch.Tensor:
    """Mean-removed phase inside the pupil mask, zero outside
    (stochasticWave.meanRmPhase, stochasticWave.m:132-142), with a
    precomputed mask and pixel count."""
    msk = mask.to(phase.dtype)
    mean = torch.sum(phase * msk, dim=(-2, -1), keepdim=True) / mask_npix
    return (phase - mean) * msk


def piston_removed_phase(basis: ZernikeBasis,
                         phase: torch.Tensor) -> torch.Tensor:
    """Mean-removed phase inside the pupil mask, zero outside
    (stochasticWave.meanRmPhase, stochasticWave.m:132-142)."""
    mask = basis.mask.to(phase.dtype)
    return piston_removed_phase_masked(phase, mask, torch.sum(mask))
