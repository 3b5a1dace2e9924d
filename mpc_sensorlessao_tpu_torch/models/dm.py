"""Deformable-mirror model (port of ``mpc_sensorlessao_tpu/models/dm.py``).

A 12x12 actuator grid with Gaussian influence functions
I_j = exp(ln(c) ((x-x0)^2+(y-y0)^2)/d^2), sampled on the DM grid, cropped
to the pupil plane and projected onto the Zernike stack with
B = pinv(Zs' Zs) Zs' B_pupil (reference: README.md:193-271).  Built once
on the host in float64 and shipped to the device as the (nx, n_act)
modal influence matrix with the piston row deleted (README.md:290).

Also the OOMAO `influenceFunction` capability (bundled but unused by the
reference pipeline): separable cubic-Bezier influence profiles with
'monotonic' / 'overshoot' presets (influenceFunction.m:49-119 control
points, :253-283 separable 2-D modes), selected by DMConfig.influence.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from scipy.interpolate import CubicSpline

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


def _pupil_crop(xaxis_dm: np.ndarray, resolution: int,
                pixel_pitch: float) -> slice:
    """The DM-grid index range of the pupil grid (README.md:256-263)."""
    pupil_axis = (np.arange(resolution) - resolution / 2) * pixel_pitch
    lo = int(np.argmin(np.abs(xaxis_dm - pupil_axis[0])))
    hi = int(np.argmin(np.abs(xaxis_dm - pupil_axis[-1])))
    if hi - lo + 1 != resolution:
        raise ValueError(f"DM grid crop {lo}..{hi} does not span "
                         f"{resolution} px")
    return slice(lo, hi + 1)


def influence_maps_pupil(cfg: DMConfig, resolution: int,
                         pixel_pitch: float) -> np.ndarray:
    """Per-actuator Gaussian bumps cropped to the pupil grid, (n_act, R, R)
    float64; actuators run row-major over (i=y, j=x) like the MATLAB double
    loop (README.md:222-263)."""
    xaxis_dm, centers = _dm_grid_axes(cfg, pixel_pitch)
    yaxis_dm = -xaxis_dm
    ycenters = -centers
    crop = _pupil_crop(xaxis_dm, resolution, pixel_pitch)

    X, Y = np.meshgrid(xaxis_dm, yaxis_dm)
    d2 = cfg.pitch ** 2
    lnc = np.log(cfg.coupling)
    maps = np.empty((cfg.n_actuators, resolution, resolution),
                    dtype=np.float64)
    k = 0
    for i in range(cfg.n_act_side):        # y loop (rows)
        for j in range(cfg.n_act_side):    # x loop (cols)
            bump = np.exp(lnc * ((X - centers[j]) ** 2 +
                                 (Y - ycenters[i]) ** 2) / d2)
            maps[k] = bump[crop, crop]
            k += 1
    return maps


def bezier_profile(mech_coupling: float, preset: str = "monotonic"):
    """1-D cubic-Bezier influence profile (influenceFunction.m:49-119).

    Two cubic Bezier segments through 7 control points; presets
    'monotonic' {0.2,[0.4,0.7],[0.6,0.4],1,1} and 'overshoot'
    {0.2,[0.4,0.7],[0.5,0.4],0.3,1} (influenceFunction.m:57-62).  The
    abscissa is rescaled so profile(1 actuator pitch) = mech_coupling
    (influenceFunction.m:116-117).  Returns (eval(r), support_radius)
    with eval vectorized over |r| in pitch units, zero outside support.
    """
    presets = {
        "monotonic": (0.2, (0.4, 0.7), (0.6, 0.4), 1.0, 1.0),
        "overshoot": (0.2, (0.4, 0.7), (0.5, 0.4), 0.3, 1.0),
    }
    if preset not in presets:
        raise ValueError(f"unknown bezier preset '{preset}'")
    c1, c2, c3, c4, c5 = presets[preset]
    P = np.zeros((7, 2))
    P[0] = [0.0, 1.0]
    P[1] = [c1, 1.0]
    P[2] = c2
    P[3] = c3
    P[4] = (-1.0 / c4) * P[2] + (1.0 + 1.0 / c4) * P[3]
    P[5] = [c5, 0.0]
    P[6] = [2.0, 0.0]
    t = np.linspace(0.0, 1.0, 101)[:, None]
    seg1 = ((1 - t) ** 3 * P[0] + 3 * (1 - t) ** 2 * t * P[1]
            + 3 * (1 - t) * t ** 2 * P[2] + t ** 3 * P[3])
    t = t[1:]
    seg2 = ((1 - t) ** 3 * P[3] + 3 * (1 - t) ** 2 * t * P[4]
            + 3 * (1 - t) * t ** 2 * P[5] + t ** 3 * P[6])
    curve = np.concatenate([seg1, seg2])                  # (201, 2) x, y
    x, y = curve[:, 0], curve[:, 1]
    # x rescale so that profile(1) = mech_coupling: invert y(x) where y is
    # decreasing over the probed range (influenceFunction.m:116)
    dec = np.argsort(y)
    x_scale = float(CubicSpline(y[dec], x[dec])(mech_coupling))
    x = x / x_scale
    # symmetric extension, cubic spline through mirrored samples
    sp = CubicSpline(np.concatenate([-x[::-1], x[1:]]),
                     np.concatenate([y[::-1], y[1:]]))
    support = float(x[-1])

    def evaluate(r):
        r = np.asarray(r, dtype=np.float64)
        return np.where(np.abs(r) <= support,
                        sp(np.clip(r, -support, support)), 0.0)

    return evaluate, support


def influence_maps_pupil_bezier(cfg: DMConfig, resolution: int,
                                pixel_pitch: float,
                                preset: str) -> np.ndarray:
    """Separable Bezier 2-D modes, same geometry as the Gaussian build
    (mode = w(y - y0) w(x - x0), influenceFunction.m:271-283), (n_act, R,
    R) float64."""
    profile, _ = bezier_profile(cfg.coupling, preset)
    xaxis_dm, centers = _dm_grid_axes(cfg, pixel_pitch)
    crop = _pupil_crop(xaxis_dm, resolution, pixel_pitch)
    wu = np.stack([profile((xaxis_dm - c) / cfg.pitch)[crop]
                   for c in centers])
    wv = np.stack([profile((-xaxis_dm + c) / cfg.pitch)[crop]
                   for c in centers])
    return np.einsum("iy,jx->ijyx", wv, wu).reshape(
        cfg.n_actuators, resolution, resolution)


def build(cfg: DMConfig, basis: zernike.ZernikeBasis,
          device: torch.device | str = "cuda") -> DMModel:
    """Modal influence matrix via Zernike LS projection (README.md:266-271)."""
    R = basis.resolution
    # keep the reference's physical geometry at any grid resolution
    pixel_pitch = cfg.pixel_pitch * 512.0 / R
    if cfg.influence == "gaussian":
        maps = influence_maps_pupil(cfg, R, pixel_pitch)
    elif cfg.influence.startswith("bezier_"):
        maps = influence_maps_pupil_bezier(
            cfg, R, pixel_pitch, cfg.influence[len("bezier_"):])
    else:
        raise ValueError(f"unknown DM influence '{cfg.influence}'")

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


def apply_correction(model: DMModel, u: torch.Tensor) -> torch.Tensor:
    """Modal correction ad_cor = B u (README.md:590); batched matmul."""
    return u @ model.influence.T


def rad_to_volts(u: torch.Tensor, a: float, b: float,
                 rad_to_nm: float) -> torch.Tensor:
    """Inverse-quadratic voltage conversion (README.md:576-583):
    V = sign(u) (-b + sqrt(b^2 + 4 a |u nm|)) / (2a)."""
    nm = u * rad_to_nm
    pos = (-b + torch.sqrt(b * b + 4.0 * a * torch.abs(nm))) / (2.0 * a)
    return torch.sign(u) * pos
