"""Kernels B1-B4: the diversity-PSF measure (ports of the Pallas kernels
of ``mpc_sensorlessao_tpu/ops/pallas_kernels.py``).

  B1 ``psf_crop_diversity_sym3``       csrc/psf_div3_sym.cu       the
     symmetric triple (-a, 0, +a): phases (B, R, R) -> (B, 3, w, w)
  B2 ``psf_crop_diversity``            csrc/psf_div.cu            any
     stack of n_div diversity maps -> (B, n_div, w, w)
  B3 ``psf_crop_intensity``            csrc/psf_crop.cu           one
     field per item, total phases (N, R, R) -> (N, w, w)
  B4 ``psf_crop_diversity_sym3_thin``  csrc/psf_div3_sym_thin.cu  B1's
     function, recombined on the thin row intermediate

On a CUDA tensor each wrapper launches its hand-written kernel (built with
nvcc at first use, bound with ctypes, counted in ``<wrapper>.launches``)
or raises; on a CPU tensor it runs its plain PyTorch version
``<wrapper>_ref``.  There is no other fallback.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build, dft

MAX_CROP = 32          # crop width the kernels' warp layout holds



def _intensity(fields: torch.Tensor, dft_op: torch.Tensor,
               scale: float) -> torch.Tensor:
    spec = dft.partial_centered_fft2(fields, dft_op)
    return (spec.real ** 2 + spec.imag ** 2) * scale


def psf_crop_diversity_sym3_ref(phase: torch.Tensor, pupil: torch.Tensor,
                                cos_a: torch.Tensor, sin_a: torch.Tensor,
                                dft_op: torch.Tensor,
                                scale: float) -> torch.Tensor:
    """Plain PyTorch version of kernel B1.

    ``cos_a``/``sin_a`` are cos/sin of the POSITIVE diversity map
    (a * Z_defocus); ``dft_op`` is the complex (w, R) partial DFT.  The
    three fields pupil e^{i(phase +- a Z)} follow by angle addition and go
    through A F A^T as complex64.
    """
    c, s = torch.cos(phase), torch.sin(phase)
    pcd, psd = pupil * cos_a, pupil * sin_a
    fields = torch.stack([
        torch.complex(c * pcd + s * psd, s * pcd - c * psd),    # -a
        torch.complex(pupil * c, pupil * s),                    #  0
        torch.complex(c * pcd - s * psd, s * pcd + c * psd),    # +a
    ], dim=1)                                                   # (B,3,R,R)
    return _intensity(fields, dft_op, scale)


def psf_crop_diversity_sym3_thin_ref(phase: torch.Tensor,
                                     pupil: torch.Tensor,
                                     cos_a: torch.Tensor,
                                     sin_a: torch.Tensor,
                                     dft_op: torch.Tensor,
                                     scale: float) -> torch.Tensor:
    """Plain PyTorch version of kernel B4: B1's function, with the six
    real products through the first DFT stage and the +- recombination
    on the (w, R) rows."""
    c, s = torch.cos(phase), torch.sin(phase)
    pcd, psd = pupil * cos_a, pupil * sin_a
    t = torch.stack([c * pcd, s * psd, s * pcd, c * psd, pupil * c,
                     pupil * s], dim=1)                         # (B,6,R,R)
    U = dft_op @ t.to(dft_op.dtype)                             # (B,6,w,R)
    rows = torch.stack([U[:, 0] + U[:, 1] + 1j * (U[:, 2] - U[:, 3]),
                        U[:, 4] + 1j * U[:, 5],
                        U[:, 0] - U[:, 1] + 1j * (U[:, 2] + U[:, 3])],
                       dim=1)                                   # (B,3,w,R)
    spec = rows @ dft_op.transpose(-1, -2)
    return (spec.real ** 2 + spec.imag ** 2) * scale


def psf_crop_diversity_ref(phase: torch.Tensor, pupil: torch.Tensor,
                           div_cos: torch.Tensor, div_sin: torch.Tensor,
                           dft_op: torch.Tensor,
                           scale: float) -> torch.Tensor:
    """Plain PyTorch version of kernel B2: the fields
    pupil e^{i(phase + div_d)} of each diversity map d from its cos/sin
    (n_div, R, R) by angle addition, through A F A^T."""
    c, s = torch.cos(phase)[:, None], torch.sin(phase)[:, None]
    fields = torch.complex(pupil * (c * div_cos - s * div_sin),
                           pupil * (s * div_cos + c * div_sin))
    return _intensity(fields, dft_op, scale)


def psf_crop_intensity_ref(phase: torch.Tensor, pupil: torch.Tensor,
                           dft_op: torch.Tensor,
                           scale: float) -> torch.Tensor:
    """Plain PyTorch version of kernel B3: |A (pupil e^{i phase}) A^T|^2
    * scale for phases (..., R, R)."""
    return _intensity(torch.complex(pupil * torch.cos(phase),
                                    pupil * torch.sin(phase)),
                      dft_op, scale)


def _check(name: str, t: torch.Tensor, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _launch(name: str, phase: torch.Tensor, maps, dft_op: torch.Tensor,
            per_item: tuple, scale: float,
            counts: tuple = ()) -> torch.Tensor:
    """Check the inputs of kernel library ``name`` and launch it on
    PyTorch's current stream.

    phase (B, R, R); ``maps`` the (label, tensor, shape) of its other
    float32 inputs; ``dft_op`` the complex64 (w, R) operator, passed as
    its real and imaginary parts; the output is (B, *per_item, w, w)
    float32.  The C entry point ``name`` takes the pointers (phase, maps,
    real and imaginary operator, output), the ints (B, *counts, R, w),
    then scale, device and stream; ``<name>_error_string`` names its
    error codes.
    """
    if phase.device.type != "cuda":
        raise ValueError(f"kernel {name} runs on CUDA tensors, got "
                         f"{phase.device}")
    if phase.dim() != 3:
        raise ValueError(f"phase must be (B, R, R), got {tuple(phase.shape)}")
    B, R = phase.shape[0], phase.shape[-1]
    w = dft_op.shape[0]
    if not 0 < w <= MAX_CROP:
        raise ValueError(f"crop width {w} outside 1..{MAX_CROP}")
    dev = phase.device
    a_ri = torch.view_as_real(dft_op).permute(2, 0, 1).contiguous()
    _check("phase", phase, (B, R, R), dev)
    for label, t, shape in maps:
        _check(label, t, shape, dev)
    _check("dft_op (real part)", a_ri[0], (w, R), dev)
    out = torch.empty((B, *per_item, w, w), dtype=torch.float32, device=dev)
    ptrs = [phase, *(t for _, t, _ in maps), a_ri[0], a_ri[1], out]
    ints = (B, *counts, R, w)
    launch = cuda_build.function(
        name, [ctypes.c_void_p] * len(ptrs) + [ctypes.c_int] * len(ints)
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    launch(*(t.data_ptr() for t in ptrs), *ints, float(scale), dev.index,
           torch.cuda.current_stream(dev).cuda_stream)
    return out


def psf_crop_diversity_sym3(phase: torch.Tensor, pupil: torch.Tensor,
                            cos_a: torch.Tensor, sin_a: torch.Tensor,
                            dft_op: torch.Tensor,
                            scale: float) -> torch.Tensor:
    """Kernel B1: fused diversity-PSF crops for the symmetric triple
    (-a, 0, +a), (B, R, R) -> (B, 3, w, w).  Same arguments as
    ``psf_crop_diversity_sym3_ref``."""
    if phase.device.type == "cpu":
        return psf_crop_diversity_sym3_ref(phase, pupil, cos_a, sin_a,
                                           dft_op, scale)
    out = _launch("psf_div3_sym", phase,
                  _sym3_maps(phase, pupil, cos_a, sin_a), dft_op, (3,), scale)
    psf_crop_diversity_sym3.launches += 1
    return out


def psf_crop_diversity_sym3_thin(phase: torch.Tensor, pupil: torch.Tensor,
                                 cos_a: torch.Tensor, sin_a: torch.Tensor,
                                 dft_op: torch.Tensor,
                                 scale: float) -> torch.Tensor:
    """Kernel B4: B1's function and arguments, with the +- recombination
    on the thin row intermediate."""
    if phase.device.type == "cpu":
        return psf_crop_diversity_sym3_thin_ref(phase, pupil, cos_a, sin_a,
                                                dft_op, scale)
    out = _launch("psf_div3_sym_thin", phase,
                  _sym3_maps(phase, pupil, cos_a, sin_a), dft_op, (3,), scale)
    psf_crop_diversity_sym3_thin.launches += 1
    return out


def _sym3_maps(phase, pupil, cos_a, sin_a):
    """B1's and B4's maps: pupil, pupil cos(a Z4), pupil sin(a Z4), each
    (R, R) of the phase's grid."""
    R = phase.shape[-1]
    return [("pupil", pupil, (R, R)),
            ("pcd", (pupil * cos_a).contiguous(), (R, R)),
            ("psd", (pupil * sin_a).contiguous(), (R, R))]


def psf_crop_diversity(phase: torch.Tensor, pupil: torch.Tensor,
                       div_cos: torch.Tensor, div_sin: torch.Tensor,
                       dft_op: torch.Tensor, scale: float) -> torch.Tensor:
    """Kernel B2: fused diversity-PSF crops for a general stack,
    (B, R, R) -> (B, n_div, w, w).  Same arguments as
    ``psf_crop_diversity_ref``."""
    if phase.device.type == "cpu":
        return psf_crop_diversity_ref(phase, pupil, div_cos, div_sin,
                                      dft_op, scale)
    n_div, R = div_cos.shape[0], phase.shape[-1]
    out = _launch("psf_div", phase,
                  [("pupil", pupil, (R, R)),
                   ("div_cos", div_cos, (n_div, R, R)),
                   ("div_sin", div_sin, (n_div, R, R))],
                  dft_op, (n_div,), scale, counts=(n_div,))
    psf_crop_diversity.launches += 1
    return out


def psf_crop_intensity(phase: torch.Tensor, pupil: torch.Tensor,
                       dft_op: torch.Tensor, scale: float) -> torch.Tensor:
    """Kernel B3: one PSF crop per total phase, (N, R, R) -> (N, w, w).
    Same arguments as ``psf_crop_intensity_ref``."""
    if phase.device.type == "cpu":
        return psf_crop_intensity_ref(phase, pupil, dft_op, scale)
    R = phase.shape[-1]
    out = _launch("psf_crop", phase, [("pupil", pupil, (R, R))], dft_op,
                  (), scale)
    psf_crop_intensity.launches += 1
    return out


psf_crop_diversity_sym3.launches = 0
psf_crop_diversity.launches = 0
psf_crop_intensity.launches = 0
psf_crop_diversity_sym3_thin.launches = 0
