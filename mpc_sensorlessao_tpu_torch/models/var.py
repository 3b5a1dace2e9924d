"""VAR(p) system identification of Zernike-coefficient dynamics (port of
``mpc_sensorlessao_tpu/models/var.py``).

Lagged least squares PARA = (AA'AA)^-1 AA' BB over the training window,
VAR matrices A_j = PARA_j' (reference: README.md:107-155), in the column
form x[k] = sum_j A_j x[k-j] + w[k].  Functions work in the dtype of
their input; the pipeline fits in float64.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class VARModel:
    """Identified VAR model; A has shape (order, nx, nx)."""

    A: torch.Tensor
    order: int

    @property
    def nx(self) -> int:
        return self.A.shape[-1]

    def coefficient(self, j: int) -> torch.Tensor:
        """A_j for lag j in 1..order."""
        return self.A[j - 1]


def lag_matrix(series: torch.Tensor, order: int):
    """(AA, BB): AA rows = [x[i-1], ..., x[i-p]], targets x[i]
    (README.md:120-125; lag j occupies columns (j-1)*nx:j*nx)."""
    T = series.shape[0]
    AA = torch.cat([series[order - j:T - j] for j in range(1, order + 1)],
                   dim=1)                                   # (T-p, p*nx)
    return AA, series[order:]


def fit(series: torch.Tensor, order: int, ridge: float = 0.0) -> VARModel:
    """Least-squares VAR fit over the window (README.md:127-130), with
    optional scale-invariant ridge lambda = ridge * mean(diag(AA'AA));
    ridge=0 is the reference's plain LS."""
    AA, BB = lag_matrix(series, order)
    gram = AA.T @ AA
    lam = ridge * torch.mean(torch.diagonal(gram))
    gram = gram + lam * torch.eye(gram.shape[0], dtype=gram.dtype,
                                  device=gram.device)
    para = torch.linalg.solve(gram, AA.T @ BB)              # (p*nx, nx)
    nx = series.shape[1]
    A = torch.stack([para[(j - 1) * nx:j * nx].T
                     for j in range(1, order + 1)])
    return VARModel(A=A, order=order)


def companion_spectral_radius(model: VARModel) -> float:
    """Spectral radius of the VAR companion matrix (host float64)."""
    p, nx = model.order, model.nx
    comp = np.zeros((p * nx, p * nx))
    A = model.A.detach().cpu().double().numpy()
    for j in range(p):
        comp[:nx, j * nx:(j + 1) * nx] = A[j]
    if p > 1:
        comp[nx:, :-nx] = np.eye((p - 1) * nx)
    return float(np.abs(np.linalg.eigvals(comp)).max())


def stabilize(model: VARModel, max_radius: float = 0.999) -> VARModel:
    """Shrink the model to spectral radius <= max_radius: scaling lag-j
    coefficients by gamma^j scales every companion eigenvalue by gamma."""
    rho = companion_spectral_radius(model)
    if rho <= max_radius:
        return model
    gamma = max_radius / rho
    scales = torch.tensor([gamma ** j for j in range(1, model.order + 1)],
                          dtype=model.A.dtype, device=model.A.device)
    return VARModel(A=model.A * scales[:, None, None], order=model.order)


def predict_one_step(model: VARModel, history: torch.Tensor) -> torch.Tensor:
    """x_hat[k] from history[..., -j, :] = x[k-j]."""
    out = 0.0
    for j in range(1, model.order + 1):
        out = out + history[..., -j, :] @ model.A[j - 1].T
    return out


def validate(model: VARModel, series: torch.Tensor):
    """One-step-ahead predictions and per-mode RMSE / RRMSE over a window
    (README.md:135-155); the window holds ``order`` warm-up samples at the
    front.  Returns (pred, rmse, rrmse)."""
    AA, BB = lag_matrix(series, model.order)
    para = torch.cat([model.A[j - 1].T for j in range(1, model.order + 1)],
                     dim=0)
    pred = AA @ para
    rmse = torch.sqrt(torch.mean((pred - BB) ** 2, dim=0))
    spread = torch.amax(BB, dim=0) - torch.amin(BB, dim=0)
    return pred, rmse, rmse / spread


def _host_A(model: VARModel) -> list[np.ndarray]:
    return [model.A[j].detach().cpu().numpy().astype(np.float64)
            for j in range(model.order)]


def innovation_covariance(model: VARModel, series) -> np.ndarray:
    """(nx, nx) sample covariance of the one-step prediction residuals
    over a series window (host float64 diagnostics)."""
    s = np.asarray(series.detach().cpu() if torch.is_tensor(series)
                   else series, dtype=np.float64)
    p = model.order
    AA = np.concatenate([s[p - j:len(s) - j] for j in range(1, p + 1)],
                        axis=1)
    para = np.concatenate([A.T for A in _host_A(model)], axis=0)
    err = AA @ para - s[p:]
    return err.T @ err / err.shape[0]


def power_spectrum(model: VARModel, sigma_w, freqs, fs: float) -> np.ndarray:
    """Two-sided PSD [state^2/Hz] of the VAR process at ``freqs`` [Hz],
    sampled at ``fs``:  S(nu) = H Sigma_w H^H / fs with
    H(nu) = (I - sum_j A_j e^{-i 2 pi nu j / fs})^{-1}.  Returns the
    (len(freqs), nx) diagonal (host float64 diagnostics)."""
    freqs = np.atleast_1d(np.asarray(freqs, dtype=np.float64))
    Sw = np.asarray(sigma_w, dtype=np.float64)
    A = _host_A(model)
    out = np.empty((len(freqs), model.nx))
    eye = np.eye(model.nx)
    for i, nu in enumerate(freqs):
        z = np.exp(-2j * np.pi * nu / fs)
        M = eye.astype(complex)
        for j, Aj in enumerate(A, start=1):
            M -= Aj * z ** j
        H = np.linalg.inv(M)
        out[i] = np.real(np.diag(H @ Sw @ H.conj().T)) / fs
    return out
