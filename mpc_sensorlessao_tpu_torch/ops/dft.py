"""Partial centered 2-D DFT as matmuls (port of
``mpc_sensorlessao_tpu/ops/dft.py``).

The estimator needs only the central (2c+1)^2 crop of
fftshift(fft2(fftshift(P))) (reference: README.md:468-471).  A *partial
centered DFT*

    Y[u, v] = sum_{x,y} X[x, y] e^{-2pi i (u-c)(x-c)/N} e^{-2pi i (v-c)(y-c)/N}
            = (A X A^T)[u, v],     A in C^{w x N},  w = crop width << N

costs two thin complex matmuls (w N^2 multiply-adds) instead of a full
N^2 log N FFT of which all but w^2 outputs are thrown away.  The identity
with the fftshift sandwich holds exactly for even N.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch


@lru_cache(maxsize=16)
def _centered_partial_dft_np(n: int, crop_half: int) -> np.ndarray:
    """A[u, x] = exp(-2pi i (u-c)(x-c)/n), u in [c-half, c+half], built in
    float64 and rounded once to complex64."""
    c = n // 2
    u = np.arange(c - crop_half, c + crop_half + 1)
    x = np.arange(n)
    phase = -2.0 * np.pi * np.outer(u - c, x - c) / n
    return np.exp(1j * phase).astype(np.complex64)


def centered_partial_dft(n: int, crop_half: int,
                         device: torch.device | str = "cuda") -> torch.Tensor:
    """(w, n) complex64 operator A, w = 2*crop_half+1."""
    return torch.as_tensor(_centered_partial_dft_np(n, crop_half),
                           device=device)


def partial_centered_fft2(field: torch.Tensor,
                          A: torch.Tensor) -> torch.Tensor:
    """A @ field @ A.T for batched complex fields (..., N, N) -> (..., w, w).

    Equals fftshift(fft2(fftshift(field)))[crop] (see module docstring).
    """
    return A @ field @ A.transpose(-1, -2)
