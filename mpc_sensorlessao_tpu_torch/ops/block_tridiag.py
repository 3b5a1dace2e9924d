"""Block-tridiagonal solves by odd-even cyclic reduction, O(log T) depth
(port of ``mpc_sensorlessao_tpu/ops/block_tridiag.py``).

The fastMPC dual Schur complement S = C Phi^-1 C' is stage-block-banded
with bandwidth = VAR order (ops/newton_kkt.py).  Each reduction level
eliminates the odd block rows with batched n x n Cholesky factors and
matmuls, halving the system: log2(T) levels of O(T n^3) work, against
the dense factorization's O(T^3 n^3).  The VAR(2) pentadiagonal case
packs stage pairs into 2n x 2n superblocks first (``pack_pairs``).

Every function is batched over the leading dims of its blocks: diag is
(..., J, n, n), one system per leading index.  SPD systems only; a block
whose Cholesky factor fails gives NaN to its own system only, as the
JAX package's ``cho_factor`` does, never an exception.
"""

from __future__ import annotations

import torch


def cho_factor(A: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of each SPD matrix of A (..., n, n); a matrix
    that is not positive definite gets an all-NaN factor (no exception),
    so that every solve with it gives NaN."""
    L, info = torch.linalg.cholesky_ex(A)
    return torch.where((info != 0)[..., None, None], torch.nan, L)


def cho_solve(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x = (L L')^-1 b for a factor of cho_factor, b (..., n, k): two
    triangular solves (batch dims broadcast), as the JAX cho_solve."""
    y = torch.linalg.solve_triangular(L, b, upper=False)
    return torch.linalg.solve_triangular(L.mT, y, upper=True)


def cr_solve(diag, sub, rhs):
    """Solve the SPD block-tridiagonal systems  S x = rhs.

    diag: (..., J, n, n) diagonal blocks D_j (symmetric);
    sub:  (..., J, n, n) sub-diagonal blocks L_j = S[j, j-1] (L_0 ignored);
    rhs:  (..., J, n) or (..., J, n, k), with diag's leading dims.

    Returns x with rhs's shape.
    """
    squeeze = rhs.dim() == diag.dim() - 1
    if squeeze:
        rhs = rhs[..., None]
    x = _cr(diag, sub, rhs)
    return x[..., 0] if squeeze else x


def _pad_identity(diag, *zero_padded):
    """Append one decoupled identity block row (identity diagonal block,
    zero blocks elsewhere) along the block dim (-3)."""
    n = diag.shape[-1]
    eye = torch.eye(n, dtype=diag.dtype, device=diag.device).expand(
        *diag.shape[:-3], 1, n, n)
    return (torch.cat([diag, eye], dim=-3),
            *(torch.cat([a, torch.zeros_like(a[..., :1, :, :])], dim=-3)
              for a in zero_padded))


def _cr(diag, sub, rhs):
    """One odd-even elimination level; recurses on the even half.

    Row j: L_j x_{j-1} + D_j x_j + L_{j+1}' x_{j+1} = b_j (L_0, L_J
    absent).  Eliminating the odd rows gives, for y_k = x_{2k}:

      D'_k = D_{2k} - L_{2k} D_{2k-1}^-1 L_{2k}'
                    - L_{2k+1}' D_{2k+1}^-1 L_{2k+1}
      L'_k = -L_{2k} D_{2k-1}^-1 L_{2k-1}
      b'_k = b_{2k} - L_{2k} D_{2k-1}^-1 b_{2k-1}
                    - L_{2k+1}' D_{2k+1}^-1 b_{2k+1}
    """
    J0 = J = diag.shape[-3]
    if J == 1:
        return cho_solve(cho_factor(diag), rhs)
    if J % 2 == 1:
        # pad a decoupled identity row so every odd row exists
        diag, sub, rhs = _pad_identity(diag, sub, rhs)
        J += 1

    d_even, d_odd = diag[..., 0::2, :, :], diag[..., 1::2, :, :]
    L_eo = sub[..., 0::2, :, :]   # L_{2k}: even row 2k <- odd row 2k-1
    L_oe = sub[..., 1::2, :, :]   # L_{2k+1}: odd row 2k+1 <- even row 2k
    b_even, b_odd = rhs[..., 0::2, :, :], rhs[..., 1::2, :, :]

    chol_odd = cho_factor(d_odd)
    iDLoe = cho_solve(chol_odd, L_oe)    # D_{2k+1}^-1 L_{2k+1}
    iDb = cho_solve(chol_odd, b_odd)     # D_{2k+1}^-1 b_{2k+1}
    # iDLeoT[m] = D_{2m+1}^-1 L_{2m+2}', m = 0..half-2
    L_next = L_eo[..., 1:, :, :]
    iDLeoT = cho_solve(chol_odd[..., :-1, :, :], L_next.mT)

    # even row 0 has no L_0: a zero block row in front
    zero = torch.zeros_like(d_even[..., :1, :, :])
    d_red = (d_even - L_oe.mT @ iDLoe
             - torch.cat([zero, L_next @ iDLeoT], dim=-3))
    sub_red = torch.cat([zero, -(L_next @ iDLoe[..., :-1, :, :])], dim=-3)
    b_red = (b_even
             - torch.cat([torch.zeros_like(iDb[..., :1, :, :]),
                          L_next @ iDb[..., :-1, :, :]], dim=-3)
             - L_oe.mT @ iDb)

    y = _cr(d_red, sub_red, b_red)                  # x at even rows

    # x_odd[k] = iDb[k] - iDLoe[k] y_k - iDLeoT[k] y_{k+1}
    x_odd = iDb - iDLoe @ y
    tail = iDLeoT @ y[..., 1:, :, :]
    x_odd = x_odd - torch.cat([tail, torch.zeros_like(x_odd[..., :1, :, :])],
                              dim=-3)
    out = torch.stack([y, x_odd], dim=-3).reshape(*y.shape[:-3], J,
                                                  *y.shape[-2:])
    return out[..., :J0, :, :]


def pack_pairs(diag, sub1, sub2):
    """Pack bandwidth-2 block-banded SPD systems (T blocks of n) into
    block-tridiagonal ones (ceil(T/2) superblocks of 2n).

    diag: (..., T, n, n) S[i, i]; sub1: (..., T, n, n) S[i, i-1] (entry 0
    ignored); sub2: (..., T, n, n) S[i, i-2] (entries 0, 1 ignored), all
    with the same leading dims.  Returns (D, L, T') for cr_solve, T' the
    padded stage count (odd T pads one identity stage).
    """
    T = diag.shape[-3]
    if T % 2 == 1:
        diag, sub1, sub2 = _pad_identity(diag, sub1, sub2)
        T += 1
    a = diag[..., 0::2, :, :]      # stage 2j
    b = diag[..., 1::2, :, :]      # stage 2j+1
    s1e = sub1[..., 0::2, :, :]    # S[2j, 2j-1]
    s1o = sub1[..., 1::2, :, :]    # S[2j+1, 2j]
    s2e = sub2[..., 0::2, :, :]    # S[2j, 2j-2]
    s2o = sub2[..., 1::2, :, :]    # S[2j+1, 2j-1]

    D = torch.cat([torch.cat([a, s1o.mT], dim=-1),
                   torch.cat([s1o, b], dim=-1)], dim=-2)       # (..., J, 2n, 2n)
    # superblock sub-diagonal: rows (2j, 2j+1) x cols (2j-2, 2j-1)
    L = torch.cat([torch.cat([s2e, s1e], dim=-1),
                   torch.cat([torch.zeros_like(a), s2o], dim=-1)], dim=-2)
    return D, L, T


def banded_solve(diag, sub1, sub2, rhs):
    """Solve SPD bandwidth-2 block-banded systems by pair packing and
    cyclic reduction.  Blocks as in pack_pairs; rhs: (..., T, n) with
    their leading dims.  Returns (..., T, n)."""
    T0, n = diag.shape[-3], diag.shape[-1]
    D, L, T = pack_pairs(diag, sub1, sub2)
    r = rhs
    if T != T0:
        r = torch.cat([rhs, torch.zeros_like(rhs[..., :1, :])], dim=-2)
    x = cr_solve(D, L, r.reshape(*r.shape[:-2], T // 2, 2 * n))
    return x.reshape(*x.shape[:-2], T, n)[..., :T0, :]
