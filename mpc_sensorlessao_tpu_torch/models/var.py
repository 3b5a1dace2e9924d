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
