"""Modal atmospheric tomography: multi-guide-star linear MMSE (port of
``mpc_sensorlessao_tpu/models/tomography.py``; linearMMSE.m 'modal'
branch, :215-241).

Estimate the Zernike coefficients of the phase in a SCIENCE direction
from coefficients measured in several GUIDE-STAR directions,

    x_sci_hat = M x_gs,    M = Cox (Cxx + Cn)^-1,

with every covariance block the analytic frozen-flow Zernike angular
covariance (ops/zernike_stats.coefficient_angular_covariance), including
an optional temporal prediction lag (the science covariance is taken
``lag`` seconds AHEAD of the guide-star measurements, so M predicts).

The tomographic error covariance and its Strehl come with it:
    Cerr = Coo - Cox (Cxx + Cn)^-1 Cox'
    strehl ~= exp(-trace(Cerr_normalized))   (Marechal).

Host float64 build (one-off); the gain is one batched matmul on
``device``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from ..ops import zernike_stats
from ..utils.config import AtmosphereConfig


@dataclass(frozen=True)
class ModalTomography:
    """Precomputed tomographic reconstructor.

    gain:      (K, n_gs*K) float32 MMSE gain tensor;
    err_cov:   (K, K) posterior error covariance (host float64, framework
               normalization);
    err_var_rad2: phase variance of the tomographic error (normalized-
               basis trace -- aperture rad^2);
    strehl_marechal: exp(-err_var).
    """

    gain: torch.Tensor
    err_cov: np.ndarray
    err_var_rad2: float
    strehl_marechal: float

    @property
    def n_modes(self) -> int:
        return self.gain.shape[0]

    @property
    def n_guide_stars(self) -> int:
        return self.gain.shape[1] // self.gain.shape[0]


def _noise_block(noise_cov, k: int) -> np.ndarray:
    """Scalar variance, (k,) diagonal or (k, k) block -> (k, k)."""
    Cn = np.asarray(noise_cov, dtype=np.float64)
    if Cn.ndim == 0:
        return Cn * np.eye(k)
    if Cn.ndim == 1:
        return np.diag(Cn)
    return Cn


def _ridged(A: np.ndarray) -> np.ndarray:
    """A + 1e-10 tr(A)/n I: a tiny ridge for near-singular covariances
    (coincident guide stars, duplicated DM modes)."""
    return A + 1e-10 * np.trace(A) / A.shape[0] * np.eye(A.shape[0])


def build(atm: AtmosphereConfig, diameter: float, radial_order: int,
          gs_directions: Sequence[tuple[float, float]],
          science_direction: tuple[float, float] = (0.0, 0.0),
          noise_cov: float | np.ndarray = 0.0, lag: float = 0.0,
          device: torch.device | str = "cuda") -> ModalTomography:
    """Assemble Cxx/Cox/Coo and solve the MMSE gain (host float64).

    gs_directions: per guide star (theta_x, theta_y) [rad];
    noise_cov: per-GS coefficient measurement noise -- scalar variance,
    (K,) diagonal, or (K, K) block (replicated across guide stars);
    lag: prediction horizon [s] (frozen flow carries the covariance).
    """
    dirs = [np.asarray(d, dtype=np.float64) for d in gs_directions]
    sci = np.asarray(science_direction, dtype=np.float64)
    n_gs = len(dirs)
    K1 = zernike_stats._mode_nm(radial_order)[0].shape[0]

    def cov(dth, tau=0.0):
        return zernike_stats.coefficient_angular_covariance(
            atm, diameter, radial_order, tuple(dth), lag=tau)

    # piston excluded everywhere (the pipeline's state convention)
    sl = slice(1, K1)
    k = K1 - 1
    Cxx = np.zeros((n_gs * k,) * 2)
    for i in range(n_gs):
        for j in range(i, n_gs):
            # C[i,j] = <a(dir_i) a(dir_j)'> -- depends on dir_i - dir_j
            blk = cov(dirs[i] - dirs[j])[sl, sl]
            Cxx[i * k:(i + 1) * k, j * k:(j + 1) * k] = blk
            if j > i:
                Cxx[j * k:(j + 1) * k, i * k:(i + 1) * k] = blk.T
    Cox = np.hstack([cov(sci - d, tau=lag)[sl, sl] for d in dirs])
    Coo = cov((0.0, 0.0))[sl, sl]

    Cxx_n = _ridged(Cxx + np.kron(np.eye(n_gs), _noise_block(noise_cov, k)))
    M = np.linalg.solve(Cxx_n, Cox.T).T
    Cerr = Coo - M @ Cox.T

    # aperture phase variance of the error: the framework-normalized
    # covariance diagonal in Noll (rms-1) modes
    Nf = zernike_stats.norm_factors(radial_order)[sl]
    err_var = float(np.sum(np.diag(Cerr) / Nf ** 2))
    return ModalTomography(
        gain=torch.as_tensor(M, dtype=torch.float32, device=device),
        err_cov=Cerr, err_var_rad2=err_var,
        strehl_marechal=float(np.exp(-max(err_var, 0.0))))


def estimate(model: ModalTomography,
             gs_coeffs: torch.Tensor) -> torch.Tensor:
    """(..., n_gs, K) guide-star coefficients -> (..., K) science-
    direction estimate (one matmul over the batch)."""
    flat = gs_coeffs.reshape(*gs_coeffs.shape[:-2], -1)
    return flat @ model.gain.T
