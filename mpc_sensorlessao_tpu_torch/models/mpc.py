"""Condensed-QP MPC problem assembly (port of
``mpc_sensorlessao_tpu/models/mpc.py``; reference: main.mlx CDATA 13,
README.md:414-501):

  X_pred = M1 x0 + M2 x0_pre + B_conv U + b_ref
  J      = U' H U + r' U + c

with M1/M2 the VAR(2) free-response recursions, B_conv = blkdiag(B,...,B),
H = 0.5 (B'QB + (B'QB)') + R_tilda and the ramp-difference matrix E.
The factory works in the dtype of its inputs (the pipeline builds in
float64); the per-step functions are batched over leading dims.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class MPCMatrices:
    """Condensed QP operators."""

    M1: torch.Tensor           # (N*nx, nx)
    M2: torch.Tensor           # (N*nx, nx)
    B_conv: torch.Tensor       # (N*nx, N*nu) block diagonal
    Q_tilda: torch.Tensor      # (N*nx, N*nx)
    R_tilda: torch.Tensor      # (N*nu, N*nu)
    E: torch.Tensor            # (N*nu, N*nu) ramp-difference
    H: torch.Tensor            # (N*nu, N*nu)
    closed_form: torch.Tensor  # (N*nu, N*nu): U = closed_form @ r
    M1B: torch.Tensor          # (N*nx, nu) = M1 @ B
    M2B: torch.Tensor          # (N*nx, nu)
    horizon: int


def free_response_matrices(A1, A2, horizon: int):
    """M1_0=A1, M1_1=A1^2+A2, M1_i=A1 M1_{i-1} + A2 M1_{i-2};
    M2_0=A2, M2_1=A1 A2, M2_i=M1_{i-1} A2  (main.mlx CDATA 13)."""
    m1 = [A1]
    m2 = [A2]
    if horizon > 1:
        m1.append(A1 @ A1 + A2)
        m2.append(A1 @ A2)
    for i in range(2, horizon):
        m1.append(A1 @ m1[i - 1] + A2 @ m1[i - 2])
        m2.append(m1[i - 1] @ A2)
    return torch.cat(m1, dim=0), torch.cat(m2, dim=0)


def ramp_difference_matrix(nu: int, horizon: int, dtype=torch.float32,
                           device=None) -> torch.Tensor:
    """E: bidiagonal +/-I blocks (main.mlx CDATA 13; N=1 -> I)."""
    E = torch.eye(horizon * nu, dtype=dtype, device=device)
    for i in range(1, horizon):
        E[i * nu:(i + 1) * nu, (i - 1) * nu:i * nu] = -torch.eye(
            nu, dtype=dtype, device=device)
    return E


def design_matrices(A1, A2, B, horizon: int, Q, P, R) -> MPCMatrices:
    """Full design-matrix factory (main.mlx CDATA 13, README.md:416-417);
    Q/P/R are full (nx,nx)/(nu,nu) stage costs, A2 zeros for VAR(1)."""
    nx, nu = B.shape
    N = horizon
    kw = dict(dtype=B.dtype, device=B.device)
    M1, M2 = free_response_matrices(A1, A2, N)
    eyeN = torch.eye(N, **kw)
    B_conv = torch.kron(eyeN, B)
    Q_tilda = torch.zeros((N * nx, N * nx), **kw)
    for i, Qi in enumerate([Q] * (N - 1) + [P]):
        Q_tilda[i * nx:(i + 1) * nx, i * nx:(i + 1) * nx] = Qi
    R_tilda = torch.kron(eyeN, R)
    BtQB = B_conv.T @ Q_tilda @ B_conv
    H = 0.5 * (BtQB + BtQB.T) + R_tilda
    return MPCMatrices(
        M1=M1, M2=M2, B_conv=B_conv, Q_tilda=Q_tilda, R_tilda=R_tilda,
        E=ramp_difference_matrix(nu, N, **kw), H=H,
        closed_form=closed_form_matrix(H, N),
        M1B=M1 @ B, M2B=M2 @ B, horizon=N)


def closed_form_matrix(H: torch.Tensor, horizon: int) -> torch.Tensor:
    """-0.5 pinv(H'H) H' (README.md:417) of the block-diagonal H (one
    (nu, nu) block a stage), block by block: H'H is block diagonal too,
    so its pseudo-inverse is the blocks' own, each cut at the whole
    matrix's cutoff 10 max(m, n) eps sigma_max (the JAX package's).
    N blocks of nu^3 work in place of (N nu)^3: at N=32, nu=144 the
    whole-matrix form takes 1.75 s on an H100 in float64."""
    nu = H.shape[0] // horizon
    idx = torch.arange(horizon, device=H.device)
    blocks = H.reshape(horizon, nu, horizon, nu)[idx, :, idx]  # (N, nu, nu)
    gram = blocks.mT @ blocks
    s_max = torch.linalg.matrix_norm(gram, ord=2).max()
    cut = 10 * H.shape[0] * torch.finfo(H.dtype).eps * s_max
    inv = torch.linalg.pinv(gram, atol=cut, rtol=0.0) @ blocks.mT
    return -0.5 * torch.block_diag(*inv)


def pinv(A: torch.Tensor) -> torch.Tensor:
    """Pseudo-inverse with the JAX package's cutoff 10 max(m, n) eps."""
    return torch.linalg.pinv(
        A, rtol=10 * max(A.shape[-2:]) * torch.finfo(A.dtype).eps)


def b_ref(mats: MPCMatrices, u_prev1, u_prev2) -> torch.Tensor:
    """b_ref = -M1 B u[k-1] - M2 B u[k-2] (README.md:491-497)."""
    return -(u_prev1 @ mats.M1B.T) - (u_prev2 @ mats.M2B.T)


def gradient_terms(mats: MPCMatrices, x0, x0_pre, bref):
    """(r, c, x_free): r = 2 B' Q (M1 x0 + M2 x0_pre + b_ref), c the
    quadratic constant (README.md:500-501)."""
    x_free = x0 @ mats.M1.T + x0_pre @ mats.M2.T + bref       # (..., N*nx)
    qx = x_free @ mats.Q_tilda.T
    r = 2.0 * (qx @ mats.B_conv)
    c = torch.sum(x_free * qx, dim=-1)
    return r, c, x_free


def predicted_states(mats: MPCMatrices, U, x_free) -> torch.Tensor:
    """X = x_free + B_conv U (README.md:592)."""
    return x_free + U @ mats.B_conv.T


def cost(mats: MPCMatrices, U, r, c) -> torch.Tensor:
    """J = U'HU + r'U + c (README.md:588)."""
    return (torch.sum(U * (U @ mats.H.T), dim=-1)
            + torch.sum(r * U, dim=-1) + c)
