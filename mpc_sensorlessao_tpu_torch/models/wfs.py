"""Shack-Hartmann wavefront sensing + slope-based reconstructors (port of
``mpc_sensorlessao_tpu/models/wfs.py``).

Equivalent of the reference's bundled-but-unused OOMAO sensing stack:
`shackHartmann.m` (1457 LoC), `lensletArray.m`, and the slope
reconstructors `linearMMSE.m` / `slopesLinearMMSE.m`.  The sensorless
pipeline never instantiates them (the paper's estimator is phase
diversity); the classical SH + integrator loop it is compared with does
(benchmarks/classical_vs_mpc.py):

* geometric slopes are ONE precomputed matmul: a (2 n_valid, R^2)
  operator averaging the phase x/y finite differences over each valid
  subaperture (the OOMAO "geometric" mode, shackHartmann.m `slopes`
  semantics);
* diffractive spots use the partial centered DFT of the estimator
  (ops/dft.py): per-subaperture tiles -> 2x zero-padding -> two thin
  complex64 matmuls -> intensity -> centroid;
* reconstructors: the least-squares pinv (the `calibrationVault` role)
  and the Bayesian MMSE gain  R = C D' (D C D' + sigma^2 I)^-1  with a
  Zernike-coefficient prior (ops/zernike_stats.py).

Host float64 setup, float32 operators on the build's device.  Phases may
carry leading batch axes: (..., R, R) -> (..., n_slopes).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..ops import dft, psf
from . import imaging


@dataclass(frozen=True)
class SHModel:
    """Precomputed Shack-Hartmann operators.

    slope_op:  (2 n_valid, R*R) geometric-slopes matmul [rad/subap -> rad
               mean-gradient per subaperture, x block then y block].
    valid:     (nl, nl) bool valid-subaperture map (host).
    sub_px:    subaperture width in pixels.
    dft_op:    (w, 2 sub_px) complex64 partial-DFT operator for the spots.
    pupil:     (R, R) pupil mask.
    sel:       (n_valid,) int64 indices of the valid subapertures in the
               row-major (nl*nl) spot stack.
    """

    slope_op: torch.Tensor
    valid: np.ndarray
    sub_px: int
    dft_op: torch.Tensor
    pupil: torch.Tensor
    sel: torch.Tensor

    @property
    def n_valid(self) -> int:
        return self.slope_op.shape[0] // 2

    @property
    def n_slopes(self) -> int:
        return self.slope_op.shape[0]


def slope_operator(pupil: np.ndarray, valid: np.ndarray,
                   sub: int) -> np.ndarray:
    """(2 n_valid, R*R) float64: the masked mean over each valid
    subaperture of the centered differences (phase[i, j+1] - phase[i,
    j-1])/2 (x rows) and (phase[i+1, j] - phase[i-1, j])/2 (y rows),
    skipped on the grid's edge columns/rows.  Each entry takes at most one
    +0.5/w and one -0.5/w, so the scatter gives the JAX package's
    per-pixel loop bit for bit."""
    R = pupil.shape[0]
    n_valid = int(valid.sum())
    G = np.zeros((2 * n_valid, R * R))
    idx = np.arange(R * R).reshape(R, R)
    for k, (li, lj) in enumerate(zip(*np.nonzero(valid))):
        m = np.zeros((R, R))
        rows = slice(li * sub, (li + 1) * sub)
        cols = slice(lj * sub, (lj + 1) * sub)
        m[rows, cols] = pupil[rows, cols]
        h = 0.5 / m.sum()
        ii, jj = np.nonzero(m)
        x = (jj > 0) & (jj < R - 1)
        y = (ii > 0) & (ii < R - 1)
        np.add.at(G[k], idx[ii[x], jj[x] + 1], h)
        np.add.at(G[k], idx[ii[x], jj[x] - 1], -h)
        np.add.at(G[n_valid + k], idx[ii[y] + 1, jj[y]], h)
        np.add.at(G[n_valid + k], idx[ii[y] - 1, jj[y]], -h)
    return G


def build(resolution: int, n_lenslet: int = 10,
          min_light_ratio: float = 0.5, crop_half: int = 3,
          device: torch.device | str = "cuda") -> SHModel:
    """Build the SH geometry + operators.

    ``n_lenslet`` subapertures across the pupil diameter;
    ``min_light_ratio`` = minimum pupil fill to validate a subaperture
    (lensletArray.minLightRatio semantics); ``crop_half`` sets the
    diffractive spot window (2c+1)^2.
    """
    R = resolution
    if R % n_lenslet != 0:
        raise ValueError(f"resolution {R} not divisible by n_lenslet "
                         f"{n_lenslet}")
    sub = R // n_lenslet
    pupil = np.asarray(psf.pupil_mask_np(R), dtype=np.float64)
    fill = pupil.reshape(n_lenslet, sub, n_lenslet, sub).sum((1, 3))
    valid = fill / (sub * sub) >= min_light_ratio
    # spots are formed on a 2x zero-padded grid: the un-padded DFT
    # critically samples the subaperture diffraction spot (1 bin =
    # lambda/d) and the windowed centroid loses its linear response to
    # sub-bin shifts; padding to lambda/(2d) bins (Nyquist) restores gain ~1
    return SHModel(
        slope_op=torch.as_tensor(slope_operator(pupil, valid, sub),
                                 dtype=torch.float32, device=device),
        valid=valid,
        sub_px=sub,
        dft_op=dft.centered_partial_dft(2 * sub, min(crop_half, sub - 1),
                                        device=device),
        pupil=torch.as_tensor(pupil, dtype=torch.float32, device=device),
        sel=torch.as_tensor(np.flatnonzero(valid.ravel()), device=device),
    )


def geometric_slopes(model: SHModel, phase: torch.Tensor) -> torch.Tensor:
    """(.., R, R) phase -> (.., 2 n_valid) mean-gradient slopes [rad/px].
    One matmul (the hot path)."""
    flat = phase.reshape(*phase.shape[:-2], -1)
    return flat @ model.slope_op.T


def spot_frames(model: SHModel, phase: torch.Tensor) -> torch.Tensor:
    """Per-subaperture diffraction spot intensities (.., nl^2, w, w) --
    the lensletArray imagelets surface (lensletArray.m:1-437), Nyquist
    sampled via 2x zero-padding (see build)."""
    R = phase.shape[-1]
    lead = phase.shape[:-2]
    sub = model.sub_px
    nl = R // sub
    field = model.pupil * torch.exp(1j * phase)
    tiles = field.reshape(*lead, nl, sub, nl, sub).transpose(-3, -2)
    tiles = tiles.reshape(*lead, nl * nl, sub, sub)
    pad = sub // 2
    tiles = torch.nn.functional.pad(tiles, (pad, pad, pad, pad))
    spots = dft.partial_centered_fft2(tiles, model.dft_op)
    return spots.real ** 2 + spots.imag ** 2


def _centroid(inten: torch.Tensor, quad_cell: bool):
    """Intensity (.., N, w, w) -> (cx, cy) in pixels (centroiding) or
    normalized quadrant imbalance (quad-cell), shackHartmann.m:515-566."""
    w = inten.shape[-1]
    tot = torch.sum(inten, dim=(-2, -1)) + 1e-20
    ax = torch.arange(w, dtype=inten.dtype, device=inten.device) \
        - (w - 1) / 2.0
    if quad_cell:
        ax = torch.sign(ax)
    cx = torch.sum(inten * ax, dim=(-2, -1)) / tot
    cy = torch.sum(inten * ax[:, None], dim=(-2, -1)) / tot
    return cx, cy


def _valid_slopes(model: SHModel, cx: torch.Tensor,
                  cy: torch.Tensor) -> torch.Tensor:
    """Centroids [bins] of the valid subapertures -> [x; y] mean
    gradients [rad/px]: one bin = 2 pi / (2 sub) rad/px."""
    scale = np.pi / model.sub_px
    return torch.cat([cx[..., model.sel], cy[..., model.sel]], dim=-1) \
        * scale


def diffractive_slopes(model: SHModel, phase: torch.Tensor) -> torch.Tensor:
    """Spot-centroid slopes from per-subaperture diffraction, in
    mean-gradient units [rad/px] so the output is directly comparable to
    geometric_slopes."""
    cx, cy = _centroid(spot_frames(model, phase), quad_cell=False)
    return _valid_slopes(model, cx, cy)


def camera_slopes(model: SHModel, phase: torch.Tensor,
                  generator: torch.Generator | None,
                  detector: imaging.DetectorConfig | None = None,
                  n_photons: float = 0.0,
                  threshold=None, quad_cell: bool = False,
                  ref_slopes: torch.Tensor | None = None,
                  remove_mean: bool = False,
                  flat_field: torch.Tensor | float = 0.0,
                  pixel_gains: torch.Tensor | float = 1.0,
                  slopes_units: float = 1.0) -> torch.Tensor:
    """Full SH camera chain: spots -> detector noise -> thresholding ->
    centroiding -> slopes [rad/px].

    The shackHartmann.m dataProcessing pipeline (:480-566) routed
    through the detector noise model (models/imaging.py):

    * ``detector``: imaging.DetectorConfig applied per spot frame
      (photon noise -> QE -> readout, detector.m:292-330), its noise
      drawn from ``generator``; None = ideal (``generator`` unused).
    * ``n_photons``: mean photons per VALID subaperture (scales the
      intensity before the noise chain); 0 keeps raw intensity units.
    * ``threshold``: None | scalar t | (t_abs, t_rel).  Scalar subtracts
      t and clamps at 0 (the 'usual thresholding',
      shackHartmann.m:504-507); a pair uses per-subaperture
      max(frame)*t_rel floored at t_abs (intensity-based thresholding,
      shackHartmann.m:493-503).
    * ``quad_cell``: quadrant imbalance instead of center-of-mass
      (shackHartmann.m:123-124,515-527); calibrate its gain externally.
    * ``ref_slopes``: subtracted reference (flat-wavefront) slopes
      (shackHartmann.m referenceSlopes semantics); None = 0.
    * ``remove_mean``: rmMeanSlopes tip/tilt removal
      (shackHartmann.m:566-571).
    * ``flat_field``/``pixel_gains``: per-pixel camera calibration
      applied to the raw frames before thresholding,
      buffer = (frame - flatField) / pixelGains
      (lensletProcessing.m:181); scalars or (w, w) / (nl^2, w, w) maps.
    * ``slopes_units``: output unit scale (lensletProcessing.m:47,208).
    """
    inten = spot_frames(model, phase)
    if n_photons > 0.0:
        flux = torch.sum(inten, dim=(-2, -1))[..., model.sel]
        mean_flux = torch.mean(flux, dim=-1)[..., None, None, None]
        inten = inten * (n_photons / (mean_flux + 1e-20))
    if detector is not None:
        inten = imaging.read_out(detector, generator, inten)
    inten = (inten - flat_field) / pixel_gains
    if threshold is not None:
        if np.ndim(threshold) == 0:
            t = threshold
        else:
            t_abs, t_rel = threshold
            t = torch.clamp(torch.amax(inten, dim=(-2, -1), keepdim=True)
                            * t_rel, min=t_abs)
        inten = torch.clamp(inten - t, min=0.0)
    cx, cy = _centroid(inten, quad_cell)
    s = _valid_slopes(model, cx, cy)
    if ref_slopes is not None:
        s = s - ref_slopes
    s = s * slopes_units
    if remove_mean:
        # rmMeanSlopes (shackHartmann.m:566-571): subtract the mean x
        # and mean y slope (tip/tilt removal at the slopes level)
        n = s.shape[-1] // 2
        s = torch.cat([s[..., :n] - torch.mean(s[..., :n], -1, True),
                       s[..., n:] - torch.mean(s[..., n:], -1, True)], -1)
    return s


def reference_slopes(model: SHModel, quad_cell: bool = False) -> torch.Tensor:
    """Flat-wavefront slopes for the camera chain (noise-free,
    threshold-free): the calibration zero point."""
    return camera_slopes(model, torch.zeros_like(model.pupil), None,
                         quad_cell=quad_cell)


def interaction_matrix(model: SHModel, mode_stack: torch.Tensor,
                       amplitude: float = 0.1,
                       diffractive: bool = False) -> torch.Tensor:
    """Calibration: poke each mode, record slopes -> (n_slopes, K).

    The geometric path is exact (linear operator); the diffractive path
    uses +/- amplitude pokes (centroid nonlinearity symmetrized), the
    OOMAO calibration procedure (calibrationVault role).
    """
    if not diffractive:
        return geometric_slopes(model, mode_stack).T
    plus = diffractive_slopes(model, amplitude * mode_stack)
    minus = diffractive_slopes(model, -amplitude * mode_stack)
    return ((plus - minus) / (2.0 * amplitude)).T


def _host(a) -> np.ndarray:
    return a.detach().cpu().double().numpy()


def ls_reconstructor(D: torch.Tensor, rcond: float = 1e-6) -> torch.Tensor:
    """Zonal/modal least-squares reconstructor pinv(D): (K, n_slopes),
    host float64, on D's device in D's dtype."""
    return torch.as_tensor(np.linalg.pinv(_host(D), rcond=rcond),
                           dtype=D.dtype, device=D.device)


def mmse_reconstructor(D: torch.Tensor, prior_cov: np.ndarray,
                       noise_var: float) -> torch.Tensor:
    """Bayesian MMSE gain R = C D' (D C D' + sigma^2 I)^-1.

    The linearMMSE / slopesLinearMMSE capability (linearMMSE.m,
    slopesLinearMMSE.m) for modal estimation: ``prior_cov`` is a
    Zernike-coefficient covariance
    (ops/zernike_stats.coefficient_covariance), ``noise_var`` the
    per-slope measurement noise variance.  Host float64 build.
    """
    Dn = _host(D)
    C = np.asarray(prior_cov, dtype=np.float64)
    CD = C @ Dn.T
    G = Dn @ CD + noise_var * np.eye(Dn.shape[0])
    return torch.as_tensor(np.linalg.solve(G, CD.T).T, dtype=D.dtype,
                           device=D.device)


def reconstruct(Rop: torch.Tensor, slopes: torch.Tensor) -> torch.Tensor:
    """x_hat = R s (batched matmul)."""
    return slopes @ Rop.T
