"""A/B of the diversity-PSF measurement kernels on one CUDA card (port of
``benchmarks/kernel_variants.py``).

    python -m mpc_sensorlessao_tpu_torch.benchmarks.kernel_variants [R] [B]

Measures the three defocus-diversity PSF crops (-a, 0, +a) (w = 31,
a = 3, scale 1.7e-3) of B seeded phases (std 0.3 rad) at resolution R
(defaults R=512, B=8) with each of the four kernels:

  general    B2, ``psf_crop_diversity`` on the cos/sin of the three maps
  sym3       B1, ``psf_crop_diversity_sym3``
  sym3_thin  B4, ``psf_crop_diversity_sym3_thin``
  unfused    B3, ``psf_crop_intensity`` on the (B*3, R, R) total phases

timed with CUDA events (``profiling.cuda_time_ms``: the median of 5
repeats of ``reps`` calls, after a warm-up), and prints one JSON line:
``<variant>_us_per_scen``, ``<variant>_rel_diff_vs_general`` (relative
difference of the output sums), ``R``, ``B``, ``device`` and ``card``
(the card's name and power limit as nvidia-smi gives them).  Raises
without a CUDA device.
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch

from ..ops import dft, psf, psf_kernels, zernike
from ..utils import profiling

VARIANTS = ("general", "sym3", "sym3_thin", "unfused")
CROP = 31
AMP = 3.0
SCALE = 1.7e-3


def inputs(R: int, B: int, device) -> dict:
    """The JAX script's inputs, made with numpy from seed 0."""
    z4 = zernike.make_basis(6, R, device="cpu").stack[4].numpy()
    rng = np.random.default_rng(0)
    phase = rng.normal(size=(B, R, R)).astype(np.float32) * 0.3
    div = np.stack([-AMP * z4, 0 * z4, AMP * z4]).astype(np.float32)

    def put(a):
        return torch.as_tensor(np.ascontiguousarray(a, np.float32),
                               device=device)

    phase_d, div_d = put(phase), put(div)
    return dict(phase=phase_d, pupil=psf.pupil_mask(R, device=device),
                div_cos=put(np.cos(div)), div_sin=put(np.sin(div)),
                cos_a=put(np.cos(AMP * z4)), sin_a=put(np.sin(AMP * z4)),
                total=(phase_d[:, None] + div_d).reshape(-1, R, R),
                dft_op=dft.centered_partial_dft(R, (CROP - 1) // 2,
                                                device=device))


def variants(inp: dict, plain: bool = False) -> dict:
    """Each variant as a call returning (B, 3, w, w): the kernels, or with
    ``plain`` their plain PyTorch versions."""
    k = psf_kernels
    if plain:
        general, sym3 = k.psf_crop_diversity_ref, k.psf_crop_diversity_sym3_ref
        thin, unfused = (k.psf_crop_diversity_sym3_thin_ref,
                         k.psf_crop_intensity_ref)
    else:
        general, sym3 = k.psf_crop_diversity, k.psf_crop_diversity_sym3
        thin, unfused = k.psf_crop_diversity_sym3_thin, k.psf_crop_intensity
    p, pup, op = inp["phase"], inp["pupil"], inp["dft_op"]
    B = p.shape[0]
    return {
        "general": lambda: general(p, pup, inp["div_cos"], inp["div_sin"],
                                   op, SCALE),
        "sym3": lambda: sym3(p, pup, inp["cos_a"], inp["sin_a"], op, SCALE),
        "sym3_thin": lambda: thin(p, pup, inp["cos_a"], inp["sin_a"], op,
                                  SCALE),
        "unfused": lambda: unfused(inp["total"], pup, op, SCALE).reshape(
            B, 3, CROP, CROP),
    }


def run(R: int, B: int, plain: bool = False, reps: int = 20) -> dict:
    """The A/B at (R, B) on the first CUDA device: the JSON line's
    fields, plus ``<variant>_ms`` per call."""
    if not torch.cuda.is_available():
        raise RuntimeError("the kernel A/B needs a CUDA device")
    inp = inputs(R, B, "cuda")
    out = {"R": R, "B": B, "device": torch.cuda.get_device_name(0),
           "plain": plain}
    ref = None
    for name, fn in variants(inp, plain).items():
        ms = profiling.cuda_time_ms(fn, reps)
        out[name + "_ms"] = ms
        out[name + "_us_per_scen"] = ms * 1e3 / B
        total = float(fn().double().sum())
        if ref is None:
            ref = total
        else:
            out[name + "_rel_diff_vs_general"] = abs(total - ref) / abs(ref)
    return out


def main() -> None:
    R = int(sys.argv[1]) if len(sys.argv) > 1 else 512
    B = int(sys.argv[2]) if len(sys.argv) > 2 else 8
    out = run(R, B)
    out["card"] = profiling.card()
    print(json.dumps(out))


if __name__ == "__main__":
    main()
