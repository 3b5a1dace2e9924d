"""Detector noise model + science imager metrics (port of
``mpc_sensorlessao_tpu/models/imaging.py``).

Equivalent of the reference's bundled-but-unused imaging chain:
`detector.m` (367 LoC) and `imager.m` (168 LoC).  The sensorless
pipeline injects precomputed SNR-10dB noise instead (README.md:473-475);
these components complete the camera capability surface for the WFS
models and for science-path evaluation.

Reference semantics replicated:

* detector.m:299-304  -- intensity binning to the detector resolution
  (utilities.binning: block sums, flux-preserving);
* detector.m:305-311  -- frame integration over `exposure_frames` ticks;
* detector.m:315-321  -- noise chain order: Poisson photon noise on
  (image + background), background subtracted, THEN quantum efficiency,
  THEN additive Gaussian readout noise;
* detector.m:9-15     -- photonNoise off / readOutNoise 0 / QE 1
  defaults;
* imager.m:98-115     -- Strehl ratio as the OTF-volume ratio
  sum(OTF_AO)/sum(OTF_DL), computed as the flux-normalized PSF peak;
* imager.m:117-126    -- encircled energy within a square of given
  width centered on the diffraction peak.

Noise is drawn from a ``torch.Generator`` on the frame's device; frames
keep their batch axes (reshape-sum binning).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class DetectorConfig(NamedTuple):
    """detector.m knobs (detector.m:9-15,63)."""

    resolution: int                 # output frame is resolution x resolution
    photon_noise: bool = False
    read_out_noise: float = 0.0     # e- rms per pixel
    quantum_efficiency: float = 1.0
    n_photon_background: float = 0.0
    exposure_frames: int = 1        # frames integrated per readout


def bin_frame(image: torch.Tensor, resolution: int) -> torch.Tensor:
    """Flux-preserving block binning (utilities.binning via
    detector.m:299-304).  Input side must be a multiple of resolution."""
    n = image.shape[-1]
    if n == resolution:
        return image
    b = n // resolution
    lead = image.shape[:-2]
    return image.reshape(*lead, resolution, b, resolution, b).sum(
        dim=(-3, -1))


def read_out(cfg: DetectorConfig, generator: torch.Generator | None,
             image: torch.Tensor) -> torch.Tensor:
    """Apply the detector noise chain to an integrated intensity frame
    (detector.m:292-330), drawing from ``generator`` (on the frame's
    device; never drawn from when the chain is noise-free)."""
    image = bin_frame(image, cfg.resolution)
    if cfg.photon_noise:
        image = torch.poisson(image + cfg.n_photon_background,
                              generator=generator).to(torch.float32) \
            - cfg.n_photon_background
    image = cfg.quantum_efficiency * image
    if cfg.read_out_noise > 0:
        image = image + cfg.read_out_noise * torch.randn(
            image.shape, generator=generator, dtype=torch.float32,
            device=image.device)
    return image


def expose(cfg: DetectorConfig, generator: torch.Generator | None,
           frames: torch.Tensor) -> torch.Tensor:
    """Integrate `exposure_frames` intensity frames then read out once
    (detector.m:305-311).  frames: (T, n, n) with T >= exposure_frames."""
    acc = torch.sum(frames[:cfg.exposure_frames], dim=0)
    return read_out(cfg, generator, acc)


# ------------------------------------------------------------------ imager

def strehl_ratio(image: torch.Tensor, reference: torch.Tensor,
                 center: bool = False) -> torch.Tensor:
    """OTF-volume Strehl (imager.m:115): sum(OTF_AO)/sum(OTF_DL).

    The OTF volume is the flux-normalized PSF peak, so no transform is
    needed: S = (peak/flux)_image / (peak/flux)_reference.

    ``center=False`` (default) takes the frame maximum as the peak --
    exact only for NOISELESS frames (detector noise biases the maximum
    high) but robust to residual tip/tilt shifting the peak off-center.
    ``center=True`` samples the known on-axis pixel instead: unbiased
    under zero-mean noise, assumes a centered PSF.
    """
    if center:
        ci, cj = image.shape[-2] // 2, image.shape[-1] // 2
        pk_i = image[..., ci, cj] / torch.sum(image, dim=(-2, -1))
        cr_i, cr_j = reference.shape[-2] // 2, reference.shape[-1] // 2
        pk_r = reference[..., cr_i, cr_j] / torch.sum(reference,
                                                      dim=(-2, -1))
    else:
        pk_i = torch.max(image) / torch.sum(image)
        pk_r = torch.max(reference) / torch.sum(reference)
    return pk_i / pk_r


def encircled_energy(image: torch.Tensor, width: int) -> torch.Tensor:
    """Fraction of total flux inside a centered width x width window
    (imager.m:117-126 eeFilter semantics, image-plane form)."""
    n = image.shape[-1]
    c = n // 2
    h = width // 2
    win = image[..., c - h:c + h + width % 2, c - h:c + h + width % 2]
    return torch.sum(win, dim=(-2, -1)) / torch.sum(image, dim=(-2, -1))


class ImagerResult(NamedTuple):
    frame: torch.Tensor
    strehl: torch.Tensor
    ee: torch.Tensor


def imager(cfg: DetectorConfig, generator: torch.Generator | None,
           frames: torch.Tensor, reference: torch.Tensor,
           ee_width: int = 4) -> ImagerResult:
    """Science camera: expose + Strehl + encircled energy
    (imager.m:70-130)."""
    frame = expose(cfg, generator, frames)
    ref = bin_frame(reference, cfg.resolution)
    return ImagerResult(frame=frame,
                        strehl=strehl_ratio(frame, ref),
                        ee=encircled_energy(frame, ee_width))


# ------------------------------------------------- image-domain utilities

def gaussian_frame(resolution: int, fwhm: float, n_f: int | None = None,
                   device: torch.device | str = "cuda") -> torch.Tensor:
    """Unit-flux Gaussian kernel frame (utilities.m:748-779 `gaussian`),
    float32 on ``device``.

    Grid convention matches the reference: u = (0:n-1) - n/2.  When
    ``n_f < resolution/2`` the reference deletes n_f rows/columns from
    each edge; replicated here as a centered crop to
    resolution - 2 n_f."""
    u = torch.arange(resolution, dtype=torch.float32,
                     device=device) - resolution / 2.0
    y, x = torch.meshgrid(u, u, indexing="ij")
    sig = fwhm / (2.0 * np.sqrt(2.0 * np.log(np.float32(2.0))))
    f = torch.exp(-(x * x + y * y) / np.float32(2.0 * sig * sig))
    f = f / torch.sum(f)
    if n_f is not None and n_f < resolution / 2:
        f = f[n_f:resolution - n_f, n_f:resolution - n_f]
    return f


def barycenter(x: torch.Tensor, y: torch.Tensor, body: torch.Tensor):
    """Intensity-weighted centroid (utilities.m:898-921 `barycenter`).

    x, y: coordinate arrays (any shape, flattened); body: weights with
    matching leading size, optionally with trailing frame axes reshaped
    to (n, k) like the reference.  Returns (x_bary, y_bary) tensors of
    length k."""
    n = x.numel()
    b = body.reshape(n, -1)
    mass = torch.sum(b, dim=0)
    xb = torch.sum(x.reshape(-1, 1) * b, dim=0) / mass
    yb = torch.sum(y.reshape(-1, 1) * b, dim=0) / mass
    return xb, yb


def fit_fwhm(profile: torch.Tensor) -> torch.Tensor:
    """Half-max contour radius of a 2-D profile (utilities.m:676-683
    `fitFwhm`), in pixels (the reference's `rc`; FWHM = 2 rc for a
    circular peak).

    The reference traces the 0.5 contour with MATLAB `contourc` and
    averages the point distances from the contour centroid.  Here the
    indicator of the above-half-max region is integrated with a subpixel
    fractional band: radius = sqrt(area / pi), which equals the mean
    contour radius for (near-)convex peaks.  Within a crossing pixel the
    profile is locally linear, so the covered fraction is
    0.5 + (p - 0.5)/|grad p| clipped to [0, 1].  For elongated peaks the
    area-equivalent radius is the geometric mean of the semi-axes."""
    p = profile / torch.max(profile)
    gy, gx = torch.gradient(p)
    g = torch.sqrt(gx * gx + gy * gy)
    frac = torch.clamp(0.5 + (p - 0.5) / torch.clamp(g, min=1e-12), 0.0,
                       1.0)
    area = torch.sum(frac)
    return torch.sqrt(area / np.pi)


def gerchberg_saxton(pupil_plane_intensity, focal_plane_intensity,
                     n_iterations: int = 300, seed: int = 0):
    """Gerchberg-Saxton phase retrieval (utilities.m:843-905, minus the
    figure plumbing), in complex128 torch.fft on the pupil intensity's
    device (numpy input runs on the CPU).

    The starting phase is drawn on the host from ``seed`` as the JAX
    package draws it, so both give the same iterates.  Returns (phase,
    convergence) with convergence[k] the Frobenius mismatch per iteration,
    matching the reference."""
    src = torch.as_tensor(pupil_plane_intensity)
    dev = src.device
    inten = torch.as_tensor(focal_plane_intensity, dtype=torch.float64,
                            device=dev)
    source = torch.sqrt(src.to(torch.float64))
    target = torch.sqrt(inten)
    rng = np.random.default_rng(seed)
    phase = torch.as_tensor(
        np.pi * (rng.random(tuple(source.shape)) * 2.0 - 1.0), device=dev)
    cvgce = torch.zeros(n_iterations, dtype=torch.float64, device=dev)

    def fsh(a):
        return torch.fft.fftshift(a, dim=(-2, -1))
    for k in range(n_iterations):
        B = source * torch.exp(1j * phase)
        C = fsh(torch.fft.fft2(fsh(B)))
        D = target * torch.exp(1j * torch.angle(C))
        A = fsh(torch.fft.ifft2(fsh(D)))
        phase = torch.angle(A)
        cvgce[k] = torch.linalg.norm(C.abs() ** 2 - inten)
    return phase, cvgce
