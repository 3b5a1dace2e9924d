"""Kernel B1: the fused diversity-PSF measure (port of
``mpc_sensorlessao_tpu/ops/pallas_kernels.py`` ``psf_crop_diversity_sym3``).

``psf_crop_diversity_sym3`` maps residual phases (B, R, R) to the three
cropped diversity PSFs (B, 3, w, w), ordered (-a, 0, +a).  On a CUDA
tensor it launches the hand-written kernel ``csrc/psf_div3_sym.cu`` (built
with nvcc at first use, bound with ctypes) or raises; on a CPU tensor it
runs ``psf_crop_diversity_sym3_ref``, the same function in plain PyTorch
through the complex partial-DFT path.  There is no other fallback.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build, dft

_LIB_NAME = "psf_div3_sym"
MAX_CROP = 32          # crop width the kernel's warp layout holds


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
    spec = dft.partial_centered_fft2(fields, dft_op)
    return (spec.real ** 2 + spec.imag ** 2) * scale


def _library() -> ctypes.CDLL:
    lib = cuda_build.load(_LIB_NAME)
    fn = lib.psf_div3_sym
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 7
                       + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_int,
                                               ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.psf_div3_sym_error_string.argtypes = [ctypes.c_int]
        lib.psf_div3_sym_error_string.restype = ctypes.c_char_p
    return lib


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


def launch_psf_div3_sym(phase: torch.Tensor, pupil: torch.Tensor,
                        pcd: torch.Tensor, psd: torch.Tensor,
                        are: torch.Tensor, aim: torch.Tensor,
                        scale: float) -> torch.Tensor:
    """Launch the CUDA kernel on PyTorch's current stream.

    phase (B, R, R); pupil, pcd = pupil cos(a Z4), psd = pupil sin(a Z4)
    (R, R); are, aim (w, R) real and imaginary DFT operator; all float32,
    contiguous, on one CUDA device.  Returns (B, 3, w, w) float32.
    """
    if phase.device.type != "cuda":
        raise ValueError(f"the B1 kernel runs on CUDA tensors, got "
                         f"{phase.device}")
    if phase.dim() != 3:
        raise ValueError(f"phase must be (B, R, R), got {tuple(phase.shape)}")
    B, R = phase.shape[0], phase.shape[-1]
    w = are.shape[0]
    if not 0 < w <= MAX_CROP:
        raise ValueError(f"crop width {w} outside 1..{MAX_CROP}")
    dev = phase.device
    _check("phase", phase, (B, R, R), dev)
    for name, t in (("pupil", pupil), ("pcd", pcd), ("psd", psd)):
        _check(name, t, (R, R), dev)
    _check("are", are, (w, R), dev)
    _check("aim", aim, (w, R), dev)
    out = torch.empty((B, 3, w, w), dtype=torch.float32, device=dev)
    lib = _library()
    err = lib.psf_div3_sym(
        phase.data_ptr(), pupil.data_ptr(), pcd.data_ptr(), psd.data_ptr(),
        are.data_ptr(), aim.data_ptr(), out.data_ptr(), B, R, w,
        float(scale), dev.index, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        msg = lib.psf_div3_sym_error_string(err).decode()
        raise RuntimeError(f"psf_div3_sym launch failed: {msg} ({err})")
    psf_crop_diversity_sym3.launches += 1
    return out


def psf_crop_diversity_sym3(phase: torch.Tensor, pupil: torch.Tensor,
                            cos_a: torch.Tensor, sin_a: torch.Tensor,
                            dft_op: torch.Tensor,
                            scale: float) -> torch.Tensor:
    """Fused diversity-PSF crops for the symmetric triple (-a, 0, +a).

    Same arguments as ``psf_crop_diversity_sym3_ref``.  A CPU tensor takes
    the plain version; a CUDA tensor launches the kernel (counted in
    ``psf_crop_diversity_sym3.launches``) or raises.
    """
    if phase.device.type == "cpu":
        return psf_crop_diversity_sym3_ref(phase, pupil, cos_a, sin_a,
                                           dft_op, scale)
    a_ri = torch.view_as_real(dft_op).permute(2, 0, 1).contiguous()
    return launch_psf_div3_sym(phase, pupil, (pupil * cos_a).contiguous(),
                               (pupil * sin_a).contiguous(), a_ri[0],
                               a_ri[1], scale)


psf_crop_diversity_sym3.launches = 0
