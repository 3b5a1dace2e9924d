"""Laser guide star: sodium-layer profile and spot elongation (port of
``mpc_sensorlessao_tpu/models/lgs.py``; laserGuideStar.m).

* slab flux weights  w_k = rho_k / h_k^2 / sum(rho/h^2)
  (laserGuideStar.m:59-63);
* per-subaperture elongation: a subaperture at transverse offset r from
  the launch axis sees slab k displaced by theta_k = r (1/h_mean - 1/h_k)
  along the radial direction; the angular extent matches
  laserGuideStar.m:37-38;
* elongated spot formation: each subaperture's diffraction spot
  (wfs.spot_frames) is convolved with its own elongation kernel -- one
  (n_sub, kw, kw) stack applied as a single grouped ``F.conv2d``
  (groups = n_sub).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

RAD2ARCSEC = 180.0 / math.pi * 3600.0


@dataclass(frozen=True)
class LGSModel:
    """Sodium-layer LGS description.

    heights:  (n_slab,) slab altitudes [m] (e.g. 90e3 + (-5..5) km);
    weights:  (n_slab,) photon fraction per slab (sums to 1);
    n_photon: total photons/m^2/s (laserGuideStar nPhoton);
    launch:   (2,) transverse launch position in the pupil [m];
    mean_altitude: focus altitude [m] (objectiveFocalLength).
    """

    heights: torch.Tensor
    weights: torch.Tensor
    n_photon: float
    launch: torch.Tensor
    mean_altitude: float


def build(heights, na_density=None, n_photon: float = 1e6,
          launch=(0.0, 0.0), mean_altitude: float | None = None,
          device: torch.device | str = "cuda") -> LGSModel:
    """Na profile -> slab weights (laserGuideStar.m:57-64).

    ``na_density=None`` = flat profile (weights follow 1/h^2)."""
    h = np.asarray(heights, dtype=np.float64)
    rho = (np.ones_like(h) if na_density is None
           else np.asarray(na_density, dtype=np.float64))
    w = rho / h ** 2
    w = w / w.sum()
    if mean_altitude is None:
        mean_altitude = float((w * h).sum())

    def f32(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float32),
                               device=device)

    return LGSModel(heights=f32(h), weights=f32(w),
                    n_photon=float(n_photon), launch=f32(launch),
                    mean_altitude=float(mean_altitude))


def angular_size_arcsec(aperture_distance: float, heights,
                        mean_altitude: float) -> float:
    """LGS angular extent seen from the furthest aperture
    (laserGuideStar.m:36-38):  d (h_max - h_min) / h_mean^2."""
    h = np.asarray(heights, dtype=np.float64)
    return float(aperture_distance * (h.max() - h.min())
                 / mean_altitude ** 2 * RAD2ARCSEC)


def elongation_offsets(model: LGSModel, sub_pos) -> torch.Tensor:
    """Per-(subaperture, slab) angular offsets (n_sub, n_slab, 2) [rad].

    sub_pos: (n_sub, 2) subaperture-center positions in the pupil [m].
    A slab at h_k, focused at h_mean, appears displaced by
    (r - launch) (1/h_mean - 1/h_k).
    """
    r = (torch.as_tensor(np.asarray(sub_pos, dtype=np.float32),
                         device=model.launch.device) - model.launch[None])
    dinv = 1.0 / model.mean_altitude - 1.0 / model.heights   # (n_slab,)
    return r[:, None, :] * dinv[None, :, None]


def _convolve2d_same(ker: torch.Tensor, g2: torch.Tensor) -> torch.Tensor:
    """scipy.signal.convolve2d(k, g2, mode="same") of each (kw, kw) slice
    of ``ker`` with the (kw, kw) ``g2``: the full convolution cropped to
    its central kw x kw part, starting at index (kw-1)//2 -- scipy's
    centering, for an even kw too."""
    kw = g2.shape[-1]
    full = F.conv2d(ker[:, None], torch.flip(g2, (0, 1))[None, None],
                    padding=kw - 1)[:, 0]          # (n, 2kw-1, 2kw-1)
    s = (kw - 1) // 2
    return full[:, s:s + kw, s:s + kw]


def elongation_kernels(model: LGSModel, sub_pos, plate_scale_rad: float,
                       kw: int, fwhm_arcsec: float = 0.0) -> torch.Tensor:
    """(n_sub, kw, kw) normalized elongation kernels on the spot grid.

    Each slab contributes weights[k] at its angular offset (bilinearly
    deposited; repeated indices accumulate); ``fwhm_arcsec`` > 0 also
    blurs with the Na-spot Gaussian.  ``plate_scale_rad``: spot-plane
    pixel size [rad/px].
    """
    off = elongation_offsets(model, sub_pos) / plate_scale_rad  # px
    n_sub, n_slab, _ = off.shape
    dev = off.device
    c = (kw - 1) / 2.0
    y = off[..., 1] + c
    x = off[..., 0] + c
    y0 = torch.clamp(torch.floor(y), 0, kw - 2).to(torch.int64)
    x0 = torch.clamp(torch.floor(x), 0, kw - 2).to(torch.int64)
    fy = torch.clamp(y - y0, 0.0, 1.0)
    fx = torch.clamp(x - x0, 0.0, 1.0)
    ker = torch.zeros((n_sub, kw, kw), dtype=torch.float32, device=dev)
    sub_idx = torch.arange(n_sub, device=dev)[:, None].expand(n_sub, n_slab)
    w = model.weights[None, :]
    for yi, xi, val in ((y0, x0, w * (1 - fy) * (1 - fx)),
                        (y0, x0 + 1, w * (1 - fy) * fx),
                        (y0 + 1, x0, w * fy * (1 - fx)),
                        (y0 + 1, x0 + 1, w * fy * fx)):
        ker.index_put_((sub_idx, yi, xi), val, accumulate=True)
    if fwhm_arcsec > 0.0:
        sig = fwhm_arcsec / RAD2ARCSEC / plate_scale_rad / 2.3548
        ax = torch.arange(kw, dtype=torch.float32, device=dev) - c
        g = torch.exp(-0.5 * (ax / sig) ** 2)
        g2 = g[:, None] * g[None, :]
        g2 = g2 / torch.sum(g2)
        ker = _convolve2d_same(ker, g2)
    return ker / (torch.sum(ker, dim=(-2, -1), keepdim=True) + 1e-20)


def elongate_spots(spots: torch.Tensor,
                   kernels: torch.Tensor) -> torch.Tensor:
    """Convolve each subaperture spot with its own elongation kernel.

    spots: (..., n_sub, w, w); kernels: (n_sub, kw, kw).  One grouped
    convolution (groups = n_sub), padded (pad, kw-1-pad) on each axis
    with pad = (kw-1)//2 -- asymmetric for an even kw, as the JAX
    package pads it.
    """
    n_sub, w = spots.shape[-3], spots.shape[-1]
    kw = kernels.shape[-1]
    lhs = spots.reshape(-1, n_sub, w, w)
    rhs = torch.flip(kernels, (-2, -1))[:, None]     # (n_sub, 1, kw, kw)
    pad = (kw - 1) // 2
    lhs = F.pad(lhs, (pad, kw - 1 - pad, pad, kw - 1 - pad))
    out = F.conv2d(lhs, rhs, groups=n_sub)
    return out.reshape(spots.shape)


def subaperture_positions(n_lenslet: int, diameter: float) -> np.ndarray:
    """(nl^2, 2) lenslet-center positions [m], row-major like
    wfs.SHModel.valid.ravel()."""
    d = diameter / n_lenslet
    c = (np.arange(n_lenslet) + 0.5) * d - diameter / 2.0
    X, Y = np.meshgrid(c, c)
    return np.stack([X.ravel(), Y.ravel()], axis=1)
