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
``<wrapper>_ref``.  There is no other fallback.  All four run both DFT
stages on the tensor cores in 3xTF32 (float32 accuracy), at any crop
width w (the Pallas kernels' range), on the Hopper engine
``csrc/psf_wgmma.cuh`` (wgmma with persistent blocks), one field policy
each: B4 computes B1's function and instantiates B1's sym3 policy
(``csrc/psf_wgmma_sym3.cuh``), so that their outputs agree bit for bit.

Each also takes ``compute_dtype="bfloat16"``, the Pallas kernels' branch
that rounds the DFT stages' operands to bf16 and sums in float32: on a
CUDA tensor the library's ``<name>_bf16`` entry point (one bf16 pass on
the same engine and policy, counted in ``<wrapper>.launches_bf16``), on
a CPU tensor the plain version rounding at the same points.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build, dft

BAND = 32              # crop band of the engine (rows and columns of a
                       # launch), and the unit its operator image pads R to


COMPUTE_DTYPES = (None, "bfloat16")


def _intensity(fields: torch.Tensor, dft_op: torch.Tensor,
               scale: float) -> torch.Tensor:
    spec = dft.partial_centered_fft2(fields, dft_op)
    return (spec.real ** 2 + spec.imag ** 2) * scale


def _check_compute_dtype(compute_dtype) -> None:
    if compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype must be one of {COMPUTE_DTYPES}, "
                         f"got {compute_dtype!r}")


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """x rounded to the nearest bfloat16 (ties to even), as float32."""
    return x.to(torch.bfloat16).float()


def _intensity_bf16(fre: torch.Tensor, fim: torch.Tensor,
                    dft_op: torch.Tensor, scale: float,
                    recombine=None) -> torch.Tensor:
    """|A F A^T|^2 * scale with the operands of both DFT stages rounded
    to bfloat16 and every sum in float32, as the Pallas kernels'
    ``compute_dtype="bfloat16"`` branch: the fields (``fre``, ``fim``,
    (..., R, R), formed in float32 by the caller) and A are rounded, the
    stage-1 rows G = A F are formed in float32 -- then ``recombine``d,
    where given -- and rounded before stage 2.  The products are float32
    matrix products of bf16 values (exact products, float32 sums: the
    caller keeps TF32 off on a GPU)."""
    are, aim = _bf16(dft_op.real), _bf16(dft_op.imag)
    fre, fim = _bf16(fre), _bf16(fim)
    gre = are @ fre - aim @ fim                                 # (...,w,R)
    gim = are @ fim + aim @ fre
    if recombine is not None:
        gre, gim = recombine(gre), recombine(gim)
    return _stage2_bf16(gre, gim, are, aim, scale)


def _stage2_bf16(gre: torch.Tensor, gim: torch.Tensor, are: torch.Tensor,
                 aim: torch.Tensor, scale: float) -> torch.Tensor:
    """|G A^T|^2 * scale from float32 stage-1 rows G (..., w, R), rounded
    to bfloat16 first, and the bf16-rounded operator's parts."""
    gre, gim = _bf16(gre), _bf16(gim)
    ore = gre @ are.T - gim @ aim.T                             # (...,w,w)
    oim = gre @ aim.T + gim @ are.T
    return (ore ** 2 + oim ** 2) * scale


def _sym3_recombine(g: torch.Tensor) -> torch.Tensor:
    """Stage-1 rows of (P, F0, Q) -> of the fields (-a, 0, +a):
    (G_P + G_Q, G_0, G_P - G_Q), on dim 1."""
    return torch.stack([g[:, 0] + g[:, 2], g[:, 1], g[:, 0] - g[:, 2]],
                       dim=1)


def psf_crop_diversity_sym3_ref(phase: torch.Tensor, pupil: torch.Tensor,
                                cos_a: torch.Tensor, sin_a: torch.Tensor,
                                dft_op: torch.Tensor, scale: float,
                                compute_dtype: str | None = None
                                ) -> torch.Tensor:
    """Plain PyTorch version of kernel B1.

    ``cos_a``/``sin_a`` are cos/sin of the POSITIVE diversity map
    (a * Z_defocus); ``dft_op`` is the complex (w, R) partial DFT.  The
    three fields pupil e^{i(phase +- a Z)} follow by angle addition and go
    through A F A^T as complex64.

    ``compute_dtype="bfloat16"`` rounds where ``_psf_div3_sym_kernel``
    rounds: the four products and the zero-diversity field, as the
    pseudo-fields P = c pcd + i s pcd, Q = s psd - i c psd and F0; their
    stage-1 rows are combined in float32 into those of the fields, G(-a)
    = G_P + G_Q and G(+a) = G_P - G_Q, and only then rounded
    (``_intensity_bf16``).
    """
    _check_compute_dtype(compute_dtype)
    c, s = torch.cos(phase), torch.sin(phase)
    pcd, psd = pupil * cos_a, pupil * sin_a
    if compute_dtype == "bfloat16":
        fre = torch.stack([c * pcd, pupil * c, s * psd], dim=1)
        fim = torch.stack([s * pcd, pupil * s, -(c * psd)], dim=1)
        return _intensity_bf16(fre, fim, dft_op, scale, _sym3_recombine)
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
                                     dft_op: torch.Tensor, scale: float,
                                     compute_dtype: str | None = None
                                     ) -> torch.Tensor:
    """Plain PyTorch version of kernel B4: B1's function, with the six
    real products through the first DFT stage and the +- recombination
    on the (w, R) rows.

    ``compute_dtype="bfloat16"`` rounds where
    ``_psf_div3_sym_thin_kernel`` rounds: A and each of the six products,
    whose stage-1 rows U_k = [Are; Aim] t_k are float32; the fields' rows
    are recombined from them in float32 and only then rounded
    (``_stage2_bf16``).
    """
    _check_compute_dtype(compute_dtype)
    c, s = torch.cos(phase), torch.sin(phase)
    pcd, psd = pupil * cos_a, pupil * sin_a
    t = torch.stack([c * pcd, s * psd, s * pcd, c * psd, pupil * c,
                     pupil * s], dim=1)                         # (B,6,R,R)
    if compute_dtype == "bfloat16":
        are, aim = _bf16(dft_op.real), _bf16(dft_op.imag)
        t = _bf16(t)
        Ur, Ui = (are @ t).unbind(1), (aim @ t).unbind(1)      # 6 x (B,w,R)
        # rr = Are fr - Aim fi, ri = Are fi + Aim fr of each field
        gre = torch.stack([Ur[0] + Ur[1] - Ui[2] + Ui[3], Ur[4] - Ui[5],
                           Ur[0] - Ur[1] - Ui[2] - Ui[3]], dim=1)
        gim = torch.stack([Ur[2] - Ur[3] + Ui[0] + Ui[1], Ur[5] + Ui[4],
                           Ur[2] + Ur[3] + Ui[0] - Ui[1]], dim=1)
        return _stage2_bf16(gre, gim, are, aim, scale)
    U = dft_op @ t.to(dft_op.dtype)                             # (B,6,w,R)
    rows = torch.stack([U[:, 0] + U[:, 1] + 1j * (U[:, 2] - U[:, 3]),
                        U[:, 4] + 1j * U[:, 5],
                        U[:, 0] - U[:, 1] + 1j * (U[:, 2] + U[:, 3])],
                       dim=1)                                   # (B,3,w,R)
    spec = rows @ dft_op.transpose(-1, -2)
    return (spec.real ** 2 + spec.imag ** 2) * scale


def psf_crop_diversity_ref(phase: torch.Tensor, pupil: torch.Tensor,
                           div_cos: torch.Tensor, div_sin: torch.Tensor,
                           dft_op: torch.Tensor, scale: float,
                           compute_dtype: str | None = None) -> torch.Tensor:
    """Plain PyTorch version of kernel B2: the fields
    pupil e^{i(phase + div_d)} of each diversity map d from its cos/sin
    (n_div, R, R) by angle addition, through A F A^T.
    ``compute_dtype="bfloat16"`` rounds where ``_psf_div_kernel`` rounds:
    each field's parts as formed in float32, A, and the stage-1 rows."""
    _check_compute_dtype(compute_dtype)
    c, s = torch.cos(phase)[:, None], torch.sin(phase)[:, None]
    fre = pupil * (c * div_cos - s * div_sin)
    fim = pupil * (s * div_cos + c * div_sin)
    if compute_dtype == "bfloat16":
        return _intensity_bf16(fre, fim, dft_op, scale)
    return _intensity(torch.complex(fre, fim), dft_op, scale)


def psf_crop_intensity_ref(phase: torch.Tensor, pupil: torch.Tensor,
                           dft_op: torch.Tensor, scale: float,
                           compute_dtype: str | None = None) -> torch.Tensor:
    """Plain PyTorch version of kernel B3: |A (pupil e^{i phase}) A^T|^2
    * scale for phases (..., R, R).  ``compute_dtype="bfloat16"`` rounds
    where ``_psf_kernel`` rounds: pupil cos, pupil sin, A and the stage-1
    rows."""
    _check_compute_dtype(compute_dtype)
    fre, fim = pupil * torch.cos(phase), pupil * torch.sin(phase)
    if compute_dtype == "bfloat16":
        return _intensity_bf16(fre, fim, dft_op, scale)
    return _intensity(torch.complex(fre, fim), dft_op, scale)


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
            per_item: tuple, scale: float, counts: tuple = (),
            compute_dtype: str | None = None) -> torch.Tensor:
    """Check the inputs of kernel library ``name`` and launch it on
    PyTorch's current stream.

    phase (B, R, R); ``maps`` the (label, tensor, shape) of its other
    float32 inputs; ``dft_op`` the complex64 (w, R) operator, passed as
    its real and imaginary parts, any w; the output is (B, *per_item, w,
    w) float32.  The C entry point -- ``name``, or ``<name>_bf16`` for
    ``compute_dtype="bfloat16"`` -- takes the pointers (phase, maps, real
    and imaginary operator, the engine's operator scratch of
    ``_operator_scratch(R, w)`` float32, output), the ints (B, *counts,
    R, w), then scale, device and stream; ``<entry>_error_string`` names
    its error codes.
    """
    entry = name if compute_dtype is None else f"{name}_bf16"
    if phase.device.type != "cuda":
        raise ValueError(f"kernel {entry} runs on CUDA tensors, got "
                         f"{phase.device}")
    if phase.dim() != 3:
        raise ValueError(f"phase must be (B, R, R), got {tuple(phase.shape)}")
    B, R = phase.shape[0], phase.shape[-1]
    w = dft_op.shape[0]
    dev = phase.device
    a_ri = torch.view_as_real(dft_op).permute(2, 0, 1).contiguous()
    _check("phase", phase, (B, R, R), dev)
    for label, t, shape in maps:
        _check(label, t, shape, dev)
    _check("dft_op (real part)", a_ri[0], (w, R), dev)
    out = torch.empty((B, *per_item, w, w), dtype=torch.float32, device=dev)
    scratch = torch.empty(_operator_scratch(R, w), dtype=torch.float32,
                          device=dev)
    ptrs = [phase, *(t for _, t, _ in maps), a_ri[0], a_ri[1], scratch, out]
    ints = (B, *counts, R, w)
    launch = cuda_build.function(
        name, [ctypes.c_void_p] * len(ptrs) + [ctypes.c_int] * len(ints)
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p], entry)
    launch(*(t.data_ptr() for t in ptrs), *ints, float(scale), dev.index,
           torch.cuda.current_stream(dev).cuda_stream)
    return out


def _count(wrapper, compute_dtype) -> None:
    """One launch of ``wrapper``'s kernel: float32 launches count in
    ``wrapper.launches``, bf16 ones in ``wrapper.launches_bf16``."""
    if compute_dtype is None:
        wrapper.launches += 1
    else:
        wrapper.launches_bf16 += 1


def psf_crop_diversity_sym3(phase: torch.Tensor, pupil: torch.Tensor,
                            cos_a: torch.Tensor, sin_a: torch.Tensor,
                            dft_op: torch.Tensor, scale: float,
                            compute_dtype: str | None = None
                            ) -> torch.Tensor:
    """Kernel B1: fused diversity-PSF crops for the symmetric triple
    (-a, 0, +a), (B, R, R) -> (B, 3, w, w).  Same arguments as
    ``psf_crop_diversity_sym3_ref``."""
    _check_compute_dtype(compute_dtype)
    if phase.device.type == "cpu":
        return psf_crop_diversity_sym3_ref(phase, pupil, cos_a, sin_a,
                                           dft_op, scale, compute_dtype)
    out = _launch("psf_div3_sym", phase,
                  _sym3_maps(phase, pupil, cos_a, sin_a), dft_op, (3,), scale,
                  compute_dtype=compute_dtype)
    _count(psf_crop_diversity_sym3, compute_dtype)
    return out


def psf_crop_diversity_sym3_thin(phase: torch.Tensor, pupil: torch.Tensor,
                                 cos_a: torch.Tensor, sin_a: torch.Tensor,
                                 dft_op: torch.Tensor, scale: float,
                                 compute_dtype: str | None = None
                                 ) -> torch.Tensor:
    """Kernel B4: B1's function and arguments, with the +- recombination
    on the thin row intermediate (its own library and launch counts, on
    B1's engine policy: the same bits as B1).  Same arguments as
    ``psf_crop_diversity_sym3_thin_ref``."""
    _check_compute_dtype(compute_dtype)
    if phase.device.type == "cpu":
        return psf_crop_diversity_sym3_thin_ref(phase, pupil, cos_a, sin_a,
                                                dft_op, scale, compute_dtype)
    out = _launch("psf_div3_sym_thin", phase,
                  _sym3_maps(phase, pupil, cos_a, sin_a), dft_op, (3,), scale,
                  compute_dtype=compute_dtype)
    _count(psf_crop_diversity_sym3_thin, compute_dtype)
    return out


def _operator_scratch(R: int, w: int) -> int:
    """Floats of the scratch in which a kernel lays its operator out, in
    bands of 32 rows: the float32 entries' 3xTF32 image on the wgmma
    engine, the stacked operator's 64 rows split into TF32 hi and lo for
    stage 1 and again for stage 2, ``256 * ceil(R / 32) * 32 *
    ceil(w / 32)``.  The bf16 entries' bf16 image needs less, ``32 *
    ceil(R / 64) * 64 * ceil(w / 32)``."""
    return 8 * BAND * BAND * -(-R // BAND) * -(-w // BAND)


def _sym3_maps(phase, pupil, cos_a, sin_a):
    """B1's and B4's maps: pupil, pupil cos(a Z4), pupil sin(a Z4), each
    (R, R) of the phase's grid."""
    R = phase.shape[-1]
    return [("pupil", pupil, (R, R)),
            ("pcd", (pupil * cos_a).contiguous(), (R, R)),
            ("psd", (pupil * sin_a).contiguous(), (R, R))]


def psf_crop_diversity(phase: torch.Tensor, pupil: torch.Tensor,
                       div_cos: torch.Tensor, div_sin: torch.Tensor,
                       dft_op: torch.Tensor, scale: float,
                       compute_dtype: str | None = None) -> torch.Tensor:
    """Kernel B2: fused diversity-PSF crops for a general stack,
    (B, R, R) -> (B, n_div, w, w).  Same arguments as
    ``psf_crop_diversity_ref``.  The kernel's maps are pupil * div_cos
    and pupil * div_sin, formed here once per call (as B1's pcd, psd)."""
    _check_compute_dtype(compute_dtype)
    if phase.device.type == "cpu":
        return psf_crop_diversity_ref(phase, pupil, div_cos, div_sin,
                                      dft_op, scale, compute_dtype)
    n_div, R = div_cos.shape[0], phase.shape[-1]
    out = _launch("psf_div", phase,
                  [("pupil * div_cos", (pupil * div_cos).contiguous(),
                    (n_div, R, R)),
                   ("pupil * div_sin", (pupil * div_sin).contiguous(),
                    (n_div, R, R))],
                  dft_op, (n_div,), scale, counts=(n_div,),
                  compute_dtype=compute_dtype)
    _count(psf_crop_diversity, compute_dtype)
    return out


def psf_crop_intensity(phase: torch.Tensor, pupil: torch.Tensor,
                       dft_op: torch.Tensor, scale: float,
                       compute_dtype: str | None = None) -> torch.Tensor:
    """Kernel B3: one PSF crop per total phase, (N, R, R) -> (N, w, w).
    Same arguments as ``psf_crop_intensity_ref``."""
    _check_compute_dtype(compute_dtype)
    if phase.device.type == "cpu":
        return psf_crop_intensity_ref(phase, pupil, dft_op, scale,
                                      compute_dtype)
    R = phase.shape[-1]
    out = _launch("psf_crop", phase, [("pupil", pupil, (R, R))], dft_op,
                  (), scale, compute_dtype=compute_dtype)
    _count(psf_crop_intensity, compute_dtype)
    return out


# launches of each kernel: float32 and bf16 (``_count``)
for _wrapper in (psf_crop_diversity_sym3, psf_crop_diversity,
                 psf_crop_intensity, psf_crop_diversity_sym3_thin):
    _wrapper.launches = _wrapper.launches_bf16 = 0
