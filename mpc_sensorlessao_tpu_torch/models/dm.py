"""Deformable-mirror model (port of ``mpc_sensorlessao_tpu/models/dm.py``).

A 12x12 actuator grid with Gaussian influence functions
I_j = exp(ln(c) ((x-x0)^2+(y-y0)^2)/d^2), sampled on the DM grid, cropped
to the pupil plane and projected onto the Zernike stack with
B = pinv(Zs' Zs) Zs' B_pupil (reference: README.md:193-271).  Built once
on the host in float64 and shipped to the device as the (nx, n_act)
modal influence matrix with the piston row deleted (README.md:290).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..ops import zernike
from ..utils.config import DMConfig


@dataclass(frozen=True)
class DMModel:
    influence: torch.Tensor       # (nx, n_act) modal influence B (no piston)
    coeff_a: float
    coeff_b: float


def _dm_grid_axes(cfg: DMConfig, pixel_pitch: float):
    """DM-plane axes and actuator center positions (README.md:206-219)."""
    len_dm = int(round(cfg.half_width * 2 / pixel_pitch))
    xaxis = (np.arange(len_dm) - len_dm / 2) * pixel_pitch
    m1 = cfg.n_act_side
    diff = len_dm // (m1 - 1)
    idx = np.array([0] + [i * diff for i in range(1, m1)])
    idx[-1] = len_dm - 1
    return xaxis, xaxis[idx]


def influence_maps_pupil(cfg: DMConfig, resolution: int,
                         pixel_pitch: float) -> np.ndarray:
    """Per-actuator Gaussian bumps cropped to the pupil grid, (n_act, R, R)
    float64; actuators run row-major over (i=y, j=x) like the MATLAB double
    loop (README.md:222-263)."""
    xaxis_dm, centers = _dm_grid_axes(cfg, pixel_pitch)
    yaxis_dm = -xaxis_dm
    ycenters = -centers

    R = resolution
    pupil_axis = (np.arange(R) - R / 2) * pixel_pitch
    lo = int(np.argmin(np.abs(xaxis_dm - pupil_axis[0])))
    hi = int(np.argmin(np.abs(xaxis_dm - pupil_axis[-1])))
    if hi - lo + 1 != R:
        raise ValueError(f"DM grid crop {lo}..{hi} does not span {R} px")

    X, Y = np.meshgrid(xaxis_dm, yaxis_dm)
    d2 = cfg.pitch ** 2
    lnc = np.log(cfg.coupling)
    maps = np.empty((cfg.n_actuators, R, R), dtype=np.float64)
    k = 0
    for i in range(cfg.n_act_side):        # y loop (rows)
        for j in range(cfg.n_act_side):    # x loop (cols)
            bump = np.exp(lnc * ((X - centers[j]) ** 2 +
                                 (Y - ycenters[i]) ** 2) / d2)
            maps[k] = bump[lo:hi + 1, lo:hi + 1]
            k += 1
    return maps


def build(cfg: DMConfig, basis: zernike.ZernikeBasis,
          device: torch.device | str = "cuda") -> DMModel:
    """Modal influence matrix via Zernike LS projection (README.md:266-271)."""
    R = basis.resolution
    # keep the reference's physical geometry at any grid resolution
    pixel_pitch = cfg.pixel_pitch * 512.0 / R
    if cfg.influence.startswith("bezier_"):
        raise NotImplementedError(
            f"DM influence '{cfg.influence}' is not ported yet "
            "(ROADMAP.md A.12)")
    if cfg.influence != "gaussian":
        raise ValueError(f"unknown DM influence '{cfg.influence}'")
    maps = influence_maps_pupil(cfg, R, pixel_pitch)

    # full-grid projection (the reference projects over the full square,
    # README.md:268-271)
    r_, th_, mask = zernike._grid_polar(R)
    z_full = np.zeros((R * R, basis.n_modes), dtype=np.float64)
    z_full[mask.ravel(), :] = zernike.eval_points(basis.radial_order,
                                                  r_[mask], th_[mask])
    proj = np.linalg.solve(z_full.T @ z_full, z_full.T)        # (K, R^2)
    B_full = proj @ maps.reshape(cfg.n_actuators, R * R).T     # (K, n_act)
    return DMModel(
        influence=torch.as_tensor(B_full[1:], dtype=torch.float32,
                                  device=device),
        coeff_a=cfg.coeff_a, coeff_b=cfg.coeff_b)


def rad_to_volts(u: torch.Tensor, a: float, b: float,
                 rad_to_nm: float) -> torch.Tensor:
    """Inverse-quadratic voltage conversion (README.md:576-583):
    V = sign(u) (-b + sqrt(b^2 + 4 a |u nm|)) / (2a)."""
    nm = u * rad_to_nm
    pos = (-b + torch.sqrt(b * b + 4.0 * a * torch.abs(nm))) / (2.0 * a)
    return torch.sign(u) * pos
