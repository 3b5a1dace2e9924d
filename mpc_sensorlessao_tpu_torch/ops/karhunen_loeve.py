"""Karhunen-Loeve modes of Von Karman turbulence (port of
``mpc_sensorlessao_tpu/ops/karhunen_loeve.py``).

Equivalent capability to the reference's bundled `karhunenLoeve.m`
(OOMAO-master, 145 LoC, unused by the pipeline): the statistically
optimal modal basis, obtained by diagonalizing the grid-propagated
Zernike-coefficient covariance (ops/zernike_stats.py) rather than
OOMAO's numerical double-integral route.  KL mode k is the
coefficient-space eigenvector v_k mapped through the Zernike stack; the
eigenvalues are the per-mode variances, sorted descending, and the modes
are statistically independent by construction.

Host numpy float64 setup (eigh and sort); the mode stack and the
projection/synthesis operators go to ``device`` as float32, and
project/synthesize are matmuls like the Zernike ones.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..utils.config import AtmosphereConfig
from . import zernike, zernike_stats


@dataclass(frozen=True)
class KLBasis:
    """KL basis over the first K Zernike modes (piston excluded).

    to_zernike:  (K, K) columns = KL modes in Zernike coefficients
                 (x_zern = to_zernike @ x_kl).
    variances:   (K,) KL mode variances [rad^2], descending.
    stack:       (K, R, R) KL mode maps (if built with a grid basis).
    """

    to_zernike: torch.Tensor
    variances: torch.Tensor
    stack: torch.Tensor | None


def make_basis(atm: AtmosphereConfig, diameter: float, radial_order: int,
               grid_basis: zernike.ZernikeBasis | None = None,
               resolution: int = 48,
               device: torch.device | str = "cuda") -> KLBasis:
    """KL modes from the grid-propagated coefficient covariance.

    ``grid_basis``: optional Zernike grid stack to materialize KL mode
    maps (stack[k] = sum_j to_zernike[j, k] Z_{j+1}).
    """
    C = zernike_stats.coefficient_covariance(
        atm, diameter, radial_order, resolution=resolution)[1:, 1:]
    w, V = np.linalg.eigh(C)
    order = np.argsort(w)[::-1]
    w, V = w[order], V[:, order]

    def f32(a):
        return torch.as_tensor(a, dtype=torch.float32, device=device)

    stack = None
    if grid_basis is not None:
        zs = grid_basis.stack[1:].detach().cpu().double().numpy()
        stack = f32(np.einsum("jk,jxy->kxy", V, zs))
    return KLBasis(to_zernike=f32(V), variances=f32(np.clip(w, 0.0, None)),
                   stack=stack)


def project(basis: KLBasis, zern_coeffs: torch.Tensor) -> torch.Tensor:
    """Zernike coefficients -> KL coefficients (orthonormal V: V')."""
    return zern_coeffs @ basis.to_zernike


def synthesize(basis: KLBasis, kl_coeffs: torch.Tensor) -> torch.Tensor:
    """KL coefficients -> Zernike coefficients."""
    return kl_coeffs @ basis.to_zernike.T
