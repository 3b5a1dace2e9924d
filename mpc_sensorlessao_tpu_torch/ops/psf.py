"""Phase-diversity PSF formation (port of ``mpc_sensorlessao_tpu/ops/psf.py``).

For each defocus diversity zd in {-zd, 0, +zd} form
P = pupil .* exp(1i (phi_res + zd Z_defocus)),
I = |fftshift(fft2(fftshift(P))) dx^2|^2, crop the central (2c+1)^2 window,
scale by AU and stack (reference: README.md:366-397,457-475).

Measurement vectors use MATLAB column-major flattening of each crop
(reference: README.md:471 `reshape(v_im, diff^2, 1)`); the layout of the
regenerated A_s/b_s depends on it.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from . import psf_kernels


@lru_cache(maxsize=8)
def pupil_mask_np(resolution: int) -> np.ndarray:
    """Circular pin-hole pupil on the centered frequency grid: disc of
    radius R/2-1 centered at index R/2 (reference: README.md:383-391)."""
    R = resolution
    ax = np.arange(R) - R // 2
    FX, FY = np.meshgrid(ax, -ax)
    return (FX * FX + FY * FY) <= (R // 2 - 1) ** 2


def pupil_mask(resolution: int, dtype=torch.float32,
               device: torch.device | str = "cuda") -> torch.Tensor:
    return torch.as_tensor(pupil_mask_np(resolution), dtype=dtype,
                           device=device)


def psf_intensity(phase: torch.Tensor, pupil: torch.Tensor,
                  scale: float) -> torch.Tensor:
    """|fftshift(fft2(fftshift(pupil e^{i phase})))|^2 * scale, (..., R, R)
    (the full-FFT path; ``scale`` folds dx^4 * AU, README.md:468-470)."""
    field = pupil * torch.exp(1j * phase.to(torch.float32))
    shifted = torch.fft.fftshift(
        torch.fft.fft2(torch.fft.fftshift(field, dim=(-2, -1))),
        dim=(-2, -1))
    return (shifted.real ** 2 + shifted.imag ** 2) * scale


def cropped_psf_intensity_dft(phase: torch.Tensor, pupil: torch.Tensor,
                              dft_op: torch.Tensor, scale: float,
                              compute_dtype: str | None = None
                              ) -> torch.Tensor:
    """PSF crop via partial centered DFT matmuls: only the (2c+1)^2 window
    the estimator consumes is computed.  The plain PyTorch path on any
    device (psf_kernels.psf_crop_intensity_ref); ``compute_dtype=
    "bfloat16"`` rounds the matmul operands as the JAX function does."""
    return psf_kernels.psf_crop_intensity_ref(phase, pupil, dft_op, scale,
                                              compute_dtype)


def crop_center(im: torch.Tensor, half: int) -> torch.Tensor:
    """Central (2*half+1)^2 window around pixel R//2 (README.md:378-380)."""
    c = im.shape[-1] // 2
    return im[..., c - half:c + half + 1, c - half:c + half + 1]


def measurement_vector(crops: torch.Tensor) -> torch.Tensor:
    """Stack diversity crops (..., n_div, w, w) into y (..., n_div*w*w),
    each crop flattened column-major (MATLAB reshape, README.md:471)."""
    w = crops.shape[-1]
    nd = crops.shape[-3]
    return crops.transpose(-1, -2).reshape(*crops.shape[:-3], nd * w * w)


def diversity_measurements(
    phase_res: torch.Tensor,
    diversity_phases: torch.Tensor,
    pupil: torch.Tensor,
    scale: float,
    crop_half: int,
    dft_op: torch.Tensor | None = None,
    div_cos: torch.Tensor | None = None,
    div_sin: torch.Tensor | None = None,
    div_sym3: bool = False,
    compute_dtype: str | None = None,
) -> torch.Tensor:
    """Full measurement path: residual phase(s) (..., R, R) -> stacked PSF
    vector(s) (..., p); diversity_phases (n_div, R, R) are the precomputed
    zd * Z_defocus maps (README.md:462-464).

    The routes of the JAX package's dispatch, each through its kernel in
    ops.psf_kernels (the CUDA kernel on a GPU tensor, its plain version on
    a CPU tensor):
      * ``dft_op`` with ``div_cos``/``div_sin`` (cos/sin of the diversity
        maps) and ``div_sym3`` (the stack is the symmetric triple
        (-a, 0, +a)): the fused measure B1;
      * ``dft_op`` with ``div_cos``/``div_sin`` otherwise: B2;
      * ``dft_op`` alone: the total phases (..., n_div, R, R) through B3;
      * no ``dft_op``: full FFT and crop in torch.fft.
    ``compute_dtype="bfloat16"`` takes each kernel's bf16 branch (bf16
    DFT operands, float32 sums); the FFT route ignores it, as the JAX
    dispatch does.
    """
    R = phase_res.shape[-1]
    if dft_op is not None and div_cos is not None:
        lead = phase_res.shape[:-2]
        flat = phase_res.reshape(-1, R, R)
        if div_sym3 and div_cos.shape[0] == 3:
            crops = psf_kernels.psf_crop_diversity_sym3(
                flat, pupil, div_cos[2], div_sin[2], dft_op, scale,
                compute_dtype)
        else:
            crops = psf_kernels.psf_crop_diversity(
                flat, pupil, div_cos, div_sin, dft_op, scale, compute_dtype)
        return measurement_vector(crops.reshape(*lead, *crops.shape[1:]))
    total = phase_res[..., None, :, :] + diversity_phases
    if dft_op is not None:
        crops = psf_kernels.psf_crop_intensity(
            total.reshape(-1, R, R), pupil, dft_op, scale, compute_dtype)
        crops = crops.reshape(*total.shape[:-2], *crops.shape[1:])
    else:
        crops = crop_center(psf_intensity(total, pupil, scale), crop_half)
    return measurement_vector(crops)
