"""Toeplitz-block-Toeplitz (TBT) operator (port of
``mpc_sensorlessao_tpu/ops/toeplitz.py``).

A matrix-free representation of 2-D stationary covariance operators (the
storage/matvec engine behind the slopes-MMSE reconstructors), storing only
the (nBr+nBc-1) x (nR+nC-1) generator instead of the full
(nBr nR) x (nBc nC) matrix.  With x reshaped to its (block, inner) grid
the matvec IS a 2-D linear convolution of x with the generator, batched
over right-hand sides.

The JAX package computes it as one ``lax.conv_general_dilated`` (the TPU
has no FFT); the port computes it as the reference does
(toeplitzBlockToeplitz.m:25-48,115-123), by FFT embedding: a circular
convolution of size >= the generator's (nBr+nBc-1, nR+nC-1) leaves the
nBr x nR outputs the matvec needs free of wrap-around.  On the card a
direct ``F.conv2d`` of a 79 x 79 generator over 512 right-hand sides took
~20 ms (cuDNN, float32; PERF.md §6, PR 14); the FFT form costs two
batched real FFTs of the grid.

Convention: dense[(bi nR + i), (bj nC + j)] = gen[bi - bj + nBc - 1,
i - j + nC - 1]; gen rows index block diagonals, columns intra-block
diagonals.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch


@dataclass(frozen=True)
class TBTOperator:
    """gen: (nBr+nBc-1, nR+nC-1) float32 generator tensor on the
    operator's device; the block and inner shapes are plain ints.
    ``spec`` is the generator's rfft2 at ``fft_shape``, the size of the
    FFT embedding, made once with the operator (``of_generator``)."""

    gen: torch.Tensor
    n_block: Tuple[int, int]
    n_inner: Tuple[int, int]
    fft_shape: Tuple[int, int]
    spec: torch.Tensor

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.n_block[0] * self.n_inner[0],
                self.n_block[1] * self.n_inner[1])

    @property
    def compression(self) -> float:
        """Dense elements per stored element."""
        return (self.shape[0] * self.shape[1]) / self.gen.numel()


def _fft_size(n: int) -> int:
    """The smallest 2^a 3^b 5^c >= n (a fast FFT length)."""
    m = n
    while True:
        k = m
        for p in (2, 3, 5):
            while k % p == 0:
                k //= p
        if k == 1:
            return m
        m += 1


def of_generator(gen: torch.Tensor, n_block: Tuple[int, int],
                 n_inner: Tuple[int, int]) -> TBTOperator:
    """The operator of a generator tensor (any float dtype and device),
    with its spectrum at the embedding's FFT size."""
    s = (_fft_size(n_block[0] + n_block[1] - 1),
         _fft_size(n_inner[0] + n_inner[1] - 1))
    return TBTOperator(gen, tuple(n_block), tuple(n_inner), s,
                       torch.fft.rfft2(gen, s=s))


def build(n_block: Tuple[int, int], n_inner: Tuple[int, int], gen,
          device: torch.device | str = "cuda") -> TBTOperator:
    nBr, nBc = n_block
    nR, nC = n_inner
    gen = torch.as_tensor(np.array(gen, dtype=np.float32), device=device)
    if tuple(gen.shape) != (nBr + nBc - 1, nR + nC - 1):
        raise ValueError(f"generator shape {tuple(gen.shape)} does not "
                         f"match blocks {n_block} x inner {n_inner}")
    return of_generator(gen, (nBr, nBc), (nR, nC))


def from_stationary(cov_fn, n: int, pitch: float,
                    device: torch.device | str = "cuda") -> TBTOperator:
    """Square TBT operator of a stationary 2-D kernel on an n x n grid:
    dense[(p1),(p2)] = cov_fn(|r1 - r2|); ``cov_fn`` is a vectorized host
    function of separation [m]."""
    d = np.arange(-(n - 1), n)
    dx, dy = np.meshgrid(d * pitch, d * pitch)
    gen = np.asarray(cov_fn(np.hypot(dx, dy)), dtype=np.float32)
    return build((n, n), (n, n), gen, device)


def matvec(op: TBTOperator, x: torch.Tensor) -> torch.Tensor:
    """y = T x on the (block, inner) grid, by FFT embedding.

    x: (..., nBc*nC) -> (..., nBr*nR), batched over leading dims.
    y[bi, i] = sum_{bj, j} gen[bi - bj + nBc - 1, i - j + nC - 1] x[bj, j]
    is entry (bi + nBc - 1, i + nC - 1) of the linear convolution of x
    with gen; a circular one of size >= gen's has no wrap-around there.
    """
    nBr, nBc = op.n_block
    nR, nC = op.n_inner
    lead = x.shape[:-1]
    s = op.fft_shape
    X = torch.fft.rfft2(x.reshape(*lead, nBc, nC), s=s)
    y = torch.fft.irfft2(X * op.spec, s=s)
    y = y[..., nBc - 1:nBc - 1 + nBr, nC - 1:nC - 1 + nR]
    return y.reshape(*lead, nBr * nR)


def full(op: TBTOperator) -> np.ndarray:
    """Dense float32 materialization (host)."""
    nBr, nBc = op.n_block
    nR, nC = op.n_inner
    gen = op.gen.detach().cpu().numpy()
    bi, bj = np.meshgrid(np.arange(nBr), np.arange(nBc), indexing="ij")
    ii, jj = np.meshgrid(np.arange(nR), np.arange(nC), indexing="ij")
    blocks = gen[(bi - bj + nBc - 1)[:, :, None, None],
                 (ii - jj + nC - 1)[None, None]]
    return blocks.transpose(0, 2, 1, 3).reshape(nBr * nR, nBc * nC)


def transpose(op: TBTOperator) -> TBTOperator:
    """T' -- the generator flipped both ways."""
    return of_generator(torch.flip(op.gen, (0, 1)),
                        (op.n_block[1], op.n_block[0]),
                        (op.n_inner[1], op.n_inner[0]))


def solve(op: TBTOperator, b) -> np.ndarray:
    """T x = b via a dense float64 factorization (host setup-time path)."""
    return np.linalg.solve(full(op).astype(np.float64), np.asarray(b))
