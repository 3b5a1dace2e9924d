"""Pyramid wavefront sensor (Fourier-filtering WFS; port of
``mpc_sensorlessao_tpu/models/pyramid.py``).

Equivalent of the reference's bundled-but-unused `pyramid.m` (504 LoC).
Reference semantics replicated (file:line in OOMAO-master/pyramid.m):

* 4-faceted focal-plane phase mask with face tilt `alpha` (default
  pi/2), normalized and fftshifted                         (:456-483)
* field embedded centered in a 2c-times padded grid
  (px_side = 2 c resolution, c default 2)                  (:148-154,400)
* tip-tilt modulation: nTheta = round(2 pi c modulation) circular
  phasor steps exp(-i pi 4 mod c r cos(o+theta)), intensities summed
  over the circle                                          (:403-420)
* detector binning px_side -> 2 c nLenslet pixels          (:91,321)
* 4-quadrant slope maps Sx = (I1-I4+I2-I3)/I, Sy = (I1-I2+I4-I3)/I,
  flux-normalized by the integrated intensity over the valid pupil
  (normalisation option 2)                                 (:463-481)
* valid pupil = disc of diameter nLenslet in the c nLenslet quadrant
  (:157-158), slopes = valid pixels of [Sx Sy] x slopesUnits (:479-481)
* gain calibration: 5-point tilt ramp, linear fit, slopesUnits =
  1/gain                                                   (:350-367)

Deliberate deviation: dataProcessing's quadrant windows (:324-344) are
off by one pixel (quadrants share a row/column); the pupil images lie
strictly inside each c nLenslet quadrant so a clean half split reads
identical valid pixels.

Both focal-plane transforms are unnormalized 2-D DFTs: the JAX package
writes them as F X F with the symmetric DFT matrix F[j,k] =
exp(-2 pi i j k / N), which is fft2(X); here they are torch.fft.fft2 in
complex64, every modulation step in one batched transform.  The mask and
the phasors are complex64 tensors.  Phases may carry leading batch axes.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch


def _pyr_mask(n: int, alpha: float) -> np.ndarray:
    """Pyramid face transmittance+phase, normalized, fftshifted
    (pyramid.m:456-483), complex64.  heaviside(0)=1/2 as in MATLAB."""
    half = n // 2
    f = (np.arange(n) - half) / half * (n // 2)   # freqspace * floor(n/2)
    fx, fy = np.meshgrid(f, f, indexing="xy")

    def heav(x):
        return np.where(x > 0, 1.0, np.where(x == 0, 0.5, 0.0))

    pym = (heav(fx) * heav(fy) * np.exp(-1j * alpha * (fx + fy))
           + heav(fx) * heav(-fy) * np.exp(-1j * alpha * (fx - fy))
           + heav(-fx) * heav(-fy) * np.exp(1j * alpha * (fx + fy))
           + heav(-fx) * heav(fy) * np.exp(-1j * alpha * (-fx + fy)))
    return np.fft.fftshift(pym / np.abs(pym).sum()).astype(np.complex64)


def _phasors(N: int, c: int, modulation: float) -> np.ndarray:
    """(nTheta, N, N) complex64 modulation phasors on the corner-origin
    polar grid the reference uses (pyramid.m:126-127,403-420)."""
    n_theta = max(int(round(2 * np.pi * c * modulation)), 1)
    if modulation <= 0:
        return np.ones((1, N, N), np.complex64)
    uu, vv = np.meshgrid(np.arange(N) / N, np.arange(N) / N, indexing="ij")
    r = np.hypot(uu, vv)
    o = np.arctan2(vv, uu)
    thetas = 2.0 * np.pi * np.arange(n_theta) / n_theta
    ph = (-np.pi * 4.0 * modulation * c
          * r[None] * np.cos(o[None] + thetas[:, None, None]))
    out = np.empty(ph.shape, np.complex64)
    out.real, out.imag = np.cos(ph), np.sin(ph)
    return out


@dataclass(frozen=True)
class PyramidModel:
    """Precomputed pyramid-WFS operators (tensors on the build's device).

    pyr_mask:  (N, N) complex64 fftshifted pyramid mask.
    phasors:   (nTheta, N, N) complex64 modulation phasors.
    pupil:     (R, R) float32 pupil amplitude mask.
    valid:     (c nl, c nl) bool valid-pupil map (host).
    sel:       (n_valid,) int64 indices of the valid pixels (row-major).
    reference_slopes: (2 n_valid,) float32 flat-wavefront slopes.
    slopes_units: output scale (1/gain after gain_calibration).
    """

    pyr_mask: torch.Tensor
    phasors: torch.Tensor
    pupil: torch.Tensor
    valid: np.ndarray
    sel: torch.Tensor
    reference_slopes: torch.Tensor
    slopes_units: float
    resolution: int
    n_lenslet: int
    c: int

    @property
    def px_side(self) -> int:
        return 2 * self.c * self.resolution

    @property
    def n_valid(self) -> int:
        return int(self.valid.sum())

    @property
    def n_slopes(self) -> int:
        return 2 * self.n_valid


def build(resolution: int, n_lenslet: int, modulation: float = 0.0,
          c: int = 2, alpha: float = np.pi / 2,
          device: torch.device | str = "cuda") -> PyramidModel:
    """Host-side precompute of every pyramid operator, moved to
    ``device``; the reference slopes of the flat wavefront (pyramid.m
    INIT, :276-284) are computed there."""
    N = 2 * c * resolution
    # pupil: disc of diameter `resolution` (utilities.piston)
    x = (np.arange(resolution) - (resolution - 1) / 2) / (resolution / 2)
    X, Y = np.meshgrid(x, x)
    pupil = (np.hypot(X, Y) <= 1.0).astype(np.float32)
    # valid intensity pupil: disc of diameter nl in the (c nl) quadrant
    q = c * n_lenslet
    xq = (np.arange(q) - (q - 1) / 2) / (n_lenslet / 2)
    Xq, Yq = np.meshgrid(xq, xq)
    valid = np.hypot(Xq, Yq) <= 1.0

    model = PyramidModel(
        pyr_mask=torch.as_tensor(_pyr_mask(N, alpha), device=device),
        phasors=torch.as_tensor(_phasors(N, c, modulation), device=device),
        pupil=torch.as_tensor(pupil, device=device),
        valid=valid,
        sel=torch.as_tensor(np.flatnonzero(valid.ravel()), device=device),
        reference_slopes=torch.zeros(2 * int(valid.sum()),
                                     dtype=torch.float32, device=device),
        slopes_units=1.0, resolution=resolution, n_lenslet=n_lenslet, c=c)
    ref = raw_slopes(model, torch.zeros((resolution, resolution),
                                        dtype=torch.float32, device=device))
    return dataclasses.replace(model, reference_slopes=ref)


def intensity_map(model: PyramidModel, phase: torch.Tensor) -> torch.Tensor:
    """(.., R, R) phase [rad] -> (.., 2 c nl, 2 c nl) binned detector image.

    The pyramid transform (pyramid.m:394-420): embed, modulate, fft2,
    mask, fft2, |.|^2, sum over the modulation circle, bin.
    """
    N = model.px_side
    R = model.resolution
    lead = phase.shape[:-2]
    wave = model.pupil * torch.exp(1j * phase)
    lo = R * (2 * model.c - 1) // 2
    q = torch.zeros(*lead, N, N, dtype=torch.complex64, device=phase.device)
    q[..., lo:lo + R, lo:lo + R] = wave
    buf = torch.fft.fft2(q[..., None, :, :] * model.phasors)
    buf = torch.fft.fft2(buf * model.pyr_mask)
    inten = torch.sum(buf.real ** 2 + buf.imag ** 2, dim=-3)
    npx = 2 * model.c * model.n_lenslet
    b = N // npx
    return inten.reshape(*lead, npx, b, npx, b).sum(dim=(-3, -1))


def raw_slopes(model: PyramidModel, phase: torch.Tensor) -> torch.Tensor:
    """Un-referenced slope vector [Sx_valid, Sy_valid]
    (pyramid.m:463-481, flux normalisation option 2)."""
    img = intensity_map(model, phase)
    h = model.c * model.n_lenslet
    I1 = img[..., :h, :h]          # top-left
    I2 = img[..., h:, :h]          # bottom-left
    I3 = img[..., h:, h:]          # bottom-right
    I4 = img[..., :h, h:]          # top-right
    # the flux over the valid pupil, gathered by the build's indices
    flux = torch.sum((I1 + I2 + I3 + I4).flatten(-2)[..., model.sel],
                     dim=-1, keepdim=True) + 1e-20
    sy = (I1 - I2 + I4 - I3).flatten(-2)[..., model.sel] / flux
    sx = (I1 - I4 + I2 - I3).flatten(-2)[..., model.sel] / flux
    return torch.cat([sx, sy], dim=-1)


def slopes(model: PyramidModel, phase: torch.Tensor) -> torch.Tensor:
    """Calibrated, reference-subtracted slopes (the sensor output)."""
    return (raw_slopes(model, phase) - model.reference_slopes) \
        * model.slopes_units


def gain_calibration(model: PyramidModel,
                     tilt_mode: torch.Tensor) -> PyramidModel:
    """Set slopesUnits from a 5-point tilt ramp (pyramid.m:350-367).

    ``tilt_mode`` is a unit-amplitude tilt phase map (e.g. Zernike mode
    index 2, the y-tilt the reference pokes via zernike(3)).  The linear
    fit runs on the host.
    """
    amps = (np.arange(5) - 2) * 0.1
    sy = [float(torch.mean(slopes(model, float(np.float32(a)) * tilt_mode)
                           [model.n_valid:])) for a in amps]
    gain = np.polyfit(4.0 * amps, np.asarray(sy), 1)[0]
    return dataclasses.replace(model,
                               slopes_units=float(np.float32(1.0 / gain)))


def interaction_matrix(model: PyramidModel, mode_stack: torch.Tensor,
                       amplitude: float = 0.05) -> torch.Tensor:
    """Poke-matrix calibration, symmetric +/- pokes -> (n_slopes, K), one
    mode at a time (each mode's modulation steps are one transform)."""
    cols = [(slopes(model, amplitude * m) - slopes(model, -amplitude * m))
            / (2.0 * amplitude) for m in mode_stack]
    return torch.stack(cols, dim=1)
