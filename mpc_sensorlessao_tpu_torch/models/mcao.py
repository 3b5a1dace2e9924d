"""Modal multi-conjugate AO (MCAO): multi-DM tomographic fitting (port of
``mpc_sensorlessao_tpu/models/mcao.py``; modalMCAO.m with
zernike.smallFootprintExpansion).

Several Zernike deformable mirrors conjugated to different altitudes are
driven from several guide-star modal measurements so that the residual
phase variance, averaged over a set of science directions, is minimized:

    u = M s,    M = R^{-1} T' S^{-1}              (modalMCAO.m:104)
    S = [<s_i s_j'>]                 guide-star data covariance
    C_k = [<s_i a_k'>]               data/target covariance, direction k
    T = sum_k w_k C_k P_k            (modalMCAO.m:86-92 target matrix)
    R = sum_k w_k P_k' P_k
    sigma^2_k = sigma^2_pistonfree - tr(2 M T_k - R_k M S M')
                                                  (modalMCAO.m:108-123)

with P_k the stacked footprint projections of every DM's meta-pupil
Zernike basis onto the direction-k pupil footprint, each a grid least-
squares fit (``footprint_projection``), and the covariance blocks from
``ops.zernike_stats.coefficient_angular_covariance``.

Everything is in the NOLL-NORMALIZED (rms-1) modal basis in the
framework's modified mode ordering, so variance traces are aperture
phase variances [rad^2] directly.  Host float64 build (one-off setup);
``correct`` and ``correction_coeffs`` are batched matmuls on ``device``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Sequence

import numpy as np
import torch

from ..ops import zernike, zernike_stats
from ..utils.config import AtmosphereConfig
from .tomography import _noise_block, _ridged


class DMLayer(NamedTuple):
    """One Zernike deformable mirror conjugated to ``altitude`` [m].

    ``radial_order``: modal content of the mirror (meta-pupil Zernike
    basis up to this order); ``skip_modes``: number of leading modes of
    the meta-pupil basis NOT actuated -- 1 drops piston, 3 drops
    piston/tip/tilt (upper DMs leave tip/tilt to the ground DM,
    modalMCAO.m:30-31).
    """

    altitude: float
    radial_order: int
    skip_modes: int = 1

    @property
    def n_act(self) -> int:
        return zernike.n_modes(self.radial_order) - self.skip_modes


@dataclass(frozen=True)
class ModalMCAO:
    """Precomputed MCAO command model.

    command:  (n_u, n_gs*(K-1)) float32 MMSE command matrix, mapping
              stacked piston-free Noll-normalized guide-star coefficient
              vectors to stacked DM commands;
    proj:     tuple over science directions of (K-1, n_u) float32
              footprint projections -- the pupil-coefficient correction in
              direction k is  proj[k] @ u;
    scao_var_rad2:   analytic residual variance of an ideal on-axis
              single-DM corrector of the same modal order [rad^2];
    mcao_var_rad2:   weighted-average MCAO residual variance;
    target_vars_rad2: per-science-direction residual variances;
    piston_free_var_rad2: uncorrected piston-removed variance.
    """

    command: torch.Tensor
    proj: tuple
    scao_var_rad2: float
    mcao_var_rad2: float
    target_vars_rad2: np.ndarray
    piston_free_var_rad2: float

    @property
    def n_u(self) -> int:
        return self.command.shape[0]


def meta_pupil_diameter(diameter: float, altitude: float,
                        fov: float) -> float:
    """D_m = D + 2 h tan(fov/2) (telescopeAbstract.m:836-845)."""
    return diameter + 2.0 * altitude * np.tan(fov / 2.0)


def footprint_projection(pupil_order: int, dm: DMLayer, diameter: float,
                         fov: float, direction=(0.0, 0.0),
                         resolution: int = 64) -> np.ndarray:
    """(K_pupil, n_act) expansion of the DM's meta-pupil modes over the
    pupil footprint seen in ``direction`` (theta_x, theta_y) [rad].

    zernike.smallFootprintExpansion(delta, alpha) with delta = 2 h theta
    / D_m (footprint center in meta-pupil-radius units) and alpha =
    D_m / D, as a grid least-squares fit: column j is the pupil-basis fit
    of meta-pupil mode j sampled on the footprint.  Both bases Noll-
    normalized.  At altitude 0 this is [I; 0] padding.
    """
    dm_diam = meta_pupil_diameter(diameter, dm.altitude, fov)
    alpha = dm_diam / diameter
    delta = (2.0 * dm.altitude / dm_diam) * np.tan(
        np.asarray(direction, dtype=np.float64))

    r, theta, mask = zernike._grid_polar(resolution)
    rr, tt = r[mask], theta[mask]
    # pupil point (in pupil-radius units) -> meta-pupil units
    x = rr * np.cos(tt) / alpha + delta[0]
    y = rr * np.sin(tt) / alpha + delta[1]
    rho = np.hypot(x, y)
    if float(rho.max()) > 1.0 + 1e-9:
        raise ValueError(
            "science footprint leaves the DM meta-pupil: direction "
            f"{tuple(np.asarray(direction))} exceeds fov/2 at altitude "
            f"{dm.altitude}")
    ang = np.arctan2(y, x)

    z_pup = (zernike.eval_points(pupil_order, rr, tt)
             * zernike_stats.norm_factors(pupil_order)[None, :])
    z_dm = (zernike.eval_points(dm.radial_order, np.minimum(rho, 1.0), ang)
            * zernike_stats.norm_factors(dm.radial_order)[None, :])
    P = np.linalg.pinv(z_pup) @ z_dm                 # (K_pupil, K_dm)
    return P[:, dm.skip_modes:]


def build(atm: AtmosphereConfig, diameter: float, fov: float,
          dms: Sequence[DMLayer], wfs_order: int,
          gs_directions: Sequence[tuple[float, float]],
          science_directions: Sequence[tuple[float, float]] = ((0.0, 0.0),),
          weights: Sequence[float] | None = None,
          noise_cov: float | np.ndarray = 0.0, resolution: int = 64,
          device: torch.device | str = "cuda") -> ModalMCAO:
    """Assemble the MCAO command matrix and its analytic performance.

    ``wfs_order``: radial order of the modal measurements (piston is
    dropped everywhere); ``gs_directions`` / ``science_directions``:
    (theta_x, theta_y) [rad]; ``weights``: optimization-direction weights
    w_k (default uniform); ``noise_cov``: per-GS coefficient measurement
    noise (scalar / (K-1,) diag / (K-1, K-1) block) -- 0 is the
    reference's noiseless problem.
    """
    gs = [np.asarray(d, dtype=np.float64) for d in gs_directions]
    sci = [np.asarray(d, dtype=np.float64) for d in science_directions]
    n_gs, n_pd = len(gs), len(sci)
    w = (np.full(n_pd, 1.0 / n_pd) if weights is None
         else np.asarray(weights, dtype=np.float64))
    K = zernike.n_modes(wfs_order)
    Km = K - 1                                        # piston dropped
    sl = slice(1, K)

    def cov(dth):
        return zernike_stats.coefficient_angular_covariance(
            atm, diameter, wfs_order, tuple(dth), normalized=True)[sl, sl]

    # footprint projections, piston row dropped (modalMCAO.m:88)
    proj = []
    for d in sci:
        P = np.hstack([footprint_projection(
            wfs_order, dm, diameter, fov, d, resolution) for dm in dms])
        proj.append(P[1:, :])

    # data covariance S (modalMCAO.m:66-77)
    S = np.zeros((n_gs * Km, n_gs * Km))
    for i in range(n_gs):
        for j in range(i, n_gs):
            blk = cov(gs[i] - gs[j])
            S[i * Km:(i + 1) * Km, j * Km:(j + 1) * Km] = blk
            if j > i:
                S[j * Km:(j + 1) * Km, i * Km:(i + 1) * Km] = blk.T

    Cn_full = np.kron(np.eye(n_gs), _noise_block(noise_cov, Km))
    S_n = _ridged(S + Cn_full)

    # data/target covariance C_k (modalMCAO.m:79-86): <s_i a_k'> =
    # cov(gs_i - sci_k), C(dth)_{pq} = <a_p(theta + dth) a_q(theta)>
    C_blocks = [np.vstack([cov(g - d) for g in gs]) for d in sci]

    # target matrices (modalMCAO.m:86-92) and R^{-1} T' S^{-1} by two
    # solves (modalMCAO.m:104)
    T = sum(wk * Ck @ Pk for wk, Ck, Pk in zip(w, C_blocks, proj))
    R = sum(wk * Pk.T @ Pk for wk, Pk in zip(w, proj))
    M = np.linalg.solve(_ridged(R), np.linalg.solve(S_n, T).T)

    # analytic variances (modalMCAO.m:108-123); measurement noise adds
    # tr(Pk'Pk M Cn M') to the noiseless MSMt term
    piston_free = zernike_stats.residual_variance(1, atm, diameter)
    scao = zernike_stats.residual_variance(K, atm, diameter)
    MSMt = M @ S @ M.T
    MNMt = M @ Cn_full @ M.T

    def resid_var(Ck, Pk):
        PtP = Pk.T @ Pk
        return float(piston_free - np.trace(2.0 * M @ (Ck @ Pk)
                                            - PtP @ MSMt)
                     + np.trace(PtP @ MNMt))

    target_vars = np.array([resid_var(Ck, Pk)
                            for Ck, Pk in zip(C_blocks, proj)])

    def f32(a):
        return torch.as_tensor(a, dtype=torch.float32, device=device)

    return ModalMCAO(
        command=f32(M), proj=tuple(f32(Pk) for Pk in proj),
        scao_var_rad2=float(scao), mcao_var_rad2=float(np.dot(w, target_vars)),
        target_vars_rad2=target_vars,
        piston_free_var_rad2=float(piston_free))


def correct(model: ModalMCAO, gs_coeffs: torch.Tensor) -> torch.Tensor:
    """(..., n_gs, K-1) piston-free Noll-normalized guide-star
    coefficients -> (..., n_u) stacked DM commands (one matmul)."""
    flat = gs_coeffs.reshape(*gs_coeffs.shape[:-2], -1)
    return flat @ model.command.T


def correction_coeffs(model: ModalMCAO, u: torch.Tensor,
                      k_science: int) -> torch.Tensor:
    """DM commands (..., n_u) -> (..., K-1) pupil-mode correction seen in
    science direction ``k_science`` (the stacked footprint projection)."""
    return u @ model.proj[k_science].T
