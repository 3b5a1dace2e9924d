"""Distributed block-tridiagonal solves: horizon parallelism (port of
``mpc_sensorlessao_tpu/parallel/horizon.py``).

The fastMPC dual Schur complement is stage-block-tridiagonal over the
horizon (ops/newton_kkt.py, ops/block_tridiag.py).  For horizons that
outgrow one device the stage axis is split over the ranks of a 1-D mesh
by sub-structuring (the partitioned / Spike scheme):

1. each rank owns a contiguous chunk of stages and condenses its
   interior unknowns onto its two boundary blocks with one local
   block-tridiagonal solve (ops.block_tridiag.cr_solve, multi-RHS);
2. the condensed system -- 2 blocks a rank, still block-tridiagonal,
   size 2 P n instead of J n -- is gathered with one ``all_gather``
   (4 n^2 + 2 n floats a rank, independent of the horizon) and solved
   on every rank;
3. each rank back-substitutes its interior unknowns.

SPD systems only (Cholesky-based elimination), like block_tridiag.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..ops import block_tridiag
from .mesh import axis_mesh

HZ_AXIS = "hz"


def hz_mesh(n_devices: int | None = None, device_type: str = "cuda"):
    """1-D mesh over the horizon axis (mesh.axis_mesh)."""
    return axis_mesh(HZ_AXIS, n_devices, device_type)


def _condense(diag, sub, rhs):
    """Condense one chunk's interior onto its (first, last) blocks.

    diag/sub/rhs: (Jl, n, n) / (Jl, n, n) / (Jl, n) local blocks --
    sub[0] couples to the PREVIOUS chunk's last block.  The coupling of
    this chunk's last row to the NEXT chunk's first block enters the
    reduced system through the neighbour's own gathered sub-block (the
    SPD solver uses S[j, j+1] = sub[j+1]^T).

    Returns the reduced 2x2-of-blocks quantities and the interior solve's
    pieces for the back-substitution.
    """
    Jl, n, _ = diag.shape
    # interior system: stages 1..Jl-2
    d_i = diag[1:-1]
    s_i = torch.cat([diag.new_zeros((1, n, n)), sub[2:-1]], dim=0)
    # multi-RHS: [b_I | E_f L_1 | E_l L_{Jl-1}^T]
    R = diag.new_zeros((Jl - 2, n, 1 + 2 * n))
    R[:, :, 0] = rhs[1:-1]
    R[0, :, 1:1 + n] = sub[1]                            # L_1
    R[-1, :, 1 + n:] = sub[Jl - 1].T                     # L_{Jl-1}^T
    sol = block_tridiag.cr_solve(d_i, s_i, R)            # (Jl-2, n, k)
    z_i = sol[:, :, 0]
    Wf = sol[:, :, 1:1 + n]
    Wl = sol[:, :, 1 + n:]

    L1T = sub[1].T
    Lm = sub[Jl - 1]
    # row f:  [D_0 - L_1^T Wf_1] x_f - L_1^T Wl_1 x_l + L_0 x_prev = bf'
    Dff = diag[0] - L1T @ Wf[0]
    bf = rhs[0] - L1T @ z_i[0]
    # row l:  -Lm Wf_last x_f + [D_last - Lm Wl_last] x_l
    #         + (L_0^{next})^T x_next = bl'
    Dll = diag[-1] - Lm @ Wl[-1]
    Clf = -Lm @ Wf[-1]                                   # l <- f coupling
    bl = rhs[-1] - Lm @ z_i[-1]
    # the f <- l coupling (-L1^T Wl[0]) is Clf^T by symmetry of the
    # condensation and enters the reduced SPD system through cr_solve's
    # S[j, j+1] = sub[j+1]^T convention -- only Clf is needed
    return Dff, Dll, Clf, bf, bl, sub[0], z_i, Wf, Wl


def solve_distributed(diag, sub, rhs, mesh) -> torch.Tensor:
    """Solve the SPD block-tridiagonal system with the stage axis split
    over ``mesh``; returns this rank's (J/P, n) rows of the solution (the
    solution stays split, as the JAX version's output sharding).

    diag: (J, n, n); sub: (J, n, n) with sub[0] ignored; rhs: (J, n) --
    whole on every rank.  J must be a multiple of the rank count P with
    J/P >= 3.
    """
    J, n, _ = diag.shape
    Pn, p = mesh.size(), mesh.get_local_rank()
    if not (J % Pn == 0 and J // Pn >= 3):
        raise ValueError(f"J={J} stages over {Pn} ranks: need J % P == 0 "
                         "and J // P >= 3")
    Jl = J // Pn
    chunk = slice(p * Jl, (p + 1) * Jl)
    (Dff, Dll, Clf, bf, bl, L0,
     z_i, Wf, Wl) = _condense(diag[chunk], sub[chunk], rhs[chunk])
    # this rank's reduced rows (2p, 2p+1): diag (Dff, Dll), sub-blocks
    # (L0 into row f from the previous rank's l; Clf into row l from f),
    # packed into one flat tensor for the one all_gather
    red = torch.cat([torch.stack([Dff, Dll]).reshape(-1),
                     torch.stack([L0, Clf]).reshape(-1),
                     torch.stack([bf, bl]).reshape(-1)])
    gathered = [torch.empty_like(red) for _ in range(Pn)]
    dist.all_gather(gathered, red, group=mesh.get_group())
    g = torch.stack(gathered)
    nn = 2 * n * n
    gd = g[:, :nn].reshape(2 * Pn, n, n)
    gs = g[:, nn:2 * nn].reshape(2 * Pn, n, n)
    gb = g[:, 2 * nn:].reshape(2 * Pn, n)
    # symmetrize the reduced diagonal (the condensation is symmetric in
    # exact arithmetic; the SPD solver needs it so)
    gd = 0.5 * (gd + gd.mT)
    y = block_tridiag.cr_solve(gd, gs, gb)               # (2P, n)
    xf, xl = y[2 * p], y[2 * p + 1]
    x_i = z_i - Wf @ xf - Wl @ xl
    return torch.cat([xf[None], x_i, xl[None]], dim=0)
