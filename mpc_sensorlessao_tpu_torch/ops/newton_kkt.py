"""Batched fixed-barrier infeasible-start Newton KKT solve ("fastMPC"),
the real-time subset (port of ``mpc_sensorlessao_tpu/ops/newton_kkt.py``;
reference: Fast_MPC/VAR_2/{inf_newton_solver.m, fast_mpc_*.m}).

  minimize  z'Hz + g'z + k * sum(-log(h - Pz))   s.t.  Cz = b

with z = (u_0, x_1, u_1, x_2, ..., u_{T-1}, x_T), ONE infeasible-start
Newton step from the midpoint init, barrier k fixed.  State is kept as
(..., T, m) control / (..., T, n) state tensors with any leading batch
dims, so a whole scenario batch is one set of matmuls.  In the
real-time mode the Newton step collapses to precomputed linear maps
(``FixedNewtonOperator``); the backtracking line search is a fixed bank
of 16 candidate steps evaluated at once.

The general multi-step ``solve`` (with ramp rows and cyclic reduction)
is not ported yet (ROADMAP.md A.8).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch


@dataclass(frozen=True)
class FastMPCProblem:
    """Static problem data shared by every scenario.

    A1, A2: (n, n) VAR coefficients (A2 zeros for VAR(1)); B: (n, m) modal
    influence; q_diag, qf_diag: (n,) stage / terminal state cost
    diagonals; r_diag: (m,) control cost diagonal; u_min, u_max: (m,)
    box; barrier_k: 0-d log-barrier parameter; du_min, du_max, u_prev:
    (m,) ramp-row data (used only by the ramp solver, not ported yet).
    """

    A1: torch.Tensor
    A2: torch.Tensor
    B: torch.Tensor
    q_diag: torch.Tensor
    qf_diag: torch.Tensor
    r_diag: torch.Tensor
    u_min: torch.Tensor
    u_max: torch.Tensor
    barrier_k: torch.Tensor
    du_min: torch.Tensor
    du_max: torch.Tensor
    u_prev: torch.Tensor


class SolverState(NamedTuple):
    U: torch.Tensor    # (..., T, m)
    X: torch.Tensor    # (..., T, n); X[t] holds x_{t+1}
    nu: torch.Tensor   # (..., T, n) equality multipliers


@dataclass(frozen=True)
class FixedNewtonOperator:
    """Precomputed single-Newton-step solve operators.

    From the midpoint init (u=0 in a symmetric box, X=0, nu=0) the primal
    Hessian Phi and the dual Schur complement S are the SAME for every
    scenario and step, and the dual residual is zero, so

        dnu = -S^-1 b,  dU_t = pu0 * (B' dnu_t),  dX_t = -px_t * (C' dnu)_x,t

    -- two small matmuls per solve; only the line search evaluates
    barrier residuals.
    """

    neg_s_inv: torch.Tensor   # (T*n, T*n)
    pu0: torch.Tensor         # (m,) 1/Phi_u at init
    px: torch.Tensor          # (T, n) 1/Phi_x


def init_state(prob: FastMPCProblem, horizon: int) -> SolverState:
    """Strictly feasible midpoint init (fast_mpc_init.m:19-27); the
    inactive x box (README.md:538) gives X=0."""
    m = prob.u_min.shape[-1]
    n = prob.A1.shape[-1]
    u0 = ((prob.u_min + prob.u_max) / 2.0).expand(horizon, m)
    zeros = torch.zeros((horizon, n), dtype=u0.dtype, device=u0.device)
    return SolverState(U=u0, X=zeros, nu=zeros)


def equality_rhs(prob: FastMPCProblem, x0, x0_pre, w, horizon: int):
    """Stacked equality rhs (..., T, n) (fast_mpc_eq_const.m:38-46):
    b_0 = A1 x0 + A2 x0_pre + w_0 ; b_1 = A2 x0 + w_1 ; b_i = w_i."""
    b = w.reshape(*w.shape[:-1], horizon, -1)
    rows = [b[..., 0, :] + x0 @ prob.A1.T + x0_pre @ prob.A2.T]
    if horizon > 1:
        rows.append(b[..., 1, :] + x0 @ prob.A2.T)
        rows.extend(b[..., i, :] for i in range(2, horizon))
    return torch.stack(rows, dim=-2)


def _shift_down(arr, k):
    """out[t] = arr[t-k] along the stage dim (-2), zero padded."""
    if k == 0:
        return arr
    pad = torch.zeros_like(arr[..., :k, :])
    return torch.cat([pad, arr[..., :-k, :]], dim=-2)


def _shift_up(arr, k):
    """out[t] = arr[t+k] along the stage dim (-2), zero padded."""
    if k == 0:
        return arr
    pad = torch.zeros_like(arr[..., :k, :])
    return torch.cat([arr[..., k:, :], pad], dim=-2)


def _q_stack(prob: FastMPCProblem, T: int) -> torch.Tensor:
    """(T, n) stage state-cost diagonals, terminal weight last."""
    return torch.cat([prob.q_diag.expand(T - 1, -1), prob.qf_diag[None]])


def residuals(prob: FastMPCProblem, b, state: SolverState):
    """Dual and primal residuals (inf_newton_solver.m:12-13).

    rd_u = 2 R u + k P'd|_u - B' nu_t
    rd_x = 2 Qt x + nu_t - A1' nu_{t+1} - A2' nu_{t+2}
    rp_i = x_{i+1} - A1 x_i - A2 x_{i-1} - B u_i - b_i
    """
    U, X, nu = state
    T = U.shape[-2]
    d_hi = 1.0 / (prob.u_max - U)
    d_lo = 1.0 / (U - prob.u_min)
    k = prob.barrier_k
    rd_u = 2.0 * prob.r_diag * U + k * (d_hi - d_lo) - nu @ prob.B
    rd_x = (2.0 * _q_stack(prob, T) * X + nu
            - _shift_up(nu, 1) @ prob.A1 - _shift_up(nu, 2) @ prob.A2)
    rp = (X - _shift_down(X, 1) @ prob.A1.T - _shift_down(X, 2) @ prob.A2.T
          - U @ prob.B.T - b)
    return rd_u, rd_x, rp


def residual_norm(rd_u, rd_x, rp):
    """Euclidean norm of all residuals, per scenario (over the last two
    dims)."""
    return torch.sqrt(torch.sum(rd_u ** 2, dim=(-2, -1))
                      + torch.sum(rd_x ** 2, dim=(-2, -1))
                      + torch.sum(rp ** 2, dim=(-2, -1)))


# line search: Armijo-style decrease factor, backtracking ratio, bank size
LS_ALPHA = 1e-4
LS_BETA = 0.5
LS_CANDIDATES = 16


def line_search_step(prob, b, state, direction):
    """Parallel-candidate norm-descent backtracking.

    A fixed bank t in {1, beta, ..., beta^15}: accept the largest t whose
    residual norm satisfies the Armijo-style decrease AND keeps the
    control strictly inside its box (replaces the sequential loop of
    backtracking_inf_newton.m:3-9); if none is accepted, take the
    smallest step.
    """
    dU, dX, dnu = direction
    base = residual_norm(*residuals(prob, b, state))           # (...)
    ts = LS_BETA ** torch.arange(LS_CANDIDATES, dtype=dU.dtype,
                                 device=dU.device)
    tc = ts[:, None, None]                                      # (C, 1, 1)

    def at(x, dx, t):
        return x.unsqueeze(-3) + t * dx.unsqueeze(-3)

    # candidates ride a new dim before the stage dim: (..., C, T, .)
    cand = SolverState(at(state.U, dU, tc), at(state.X, dX, tc),
                       at(state.nu, dnu, tc))
    norm = residual_norm(*residuals(prob, b.unsqueeze(-3), cand))
    feasible = ((cand.U < prob.u_max).all(dim=(-2, -1))
                & (cand.U > prob.u_min).all(dim=(-2, -1)))
    oks = (norm <= (1.0 - LS_ALPHA * ts) * base[..., None]) & feasible
    # first accepted candidate (argmax of the int cast picks the first
    # True); fall back to the smallest step
    idx = torch.argmax(oks.to(torch.int8), dim=-1)
    t = torch.where(oks.any(dim=-1), ts[idx], ts[-1])[..., None, None]
    return SolverState(state.U + t * dU, state.X + t * dX,
                       state.nu + t * dnu)


def precompute_fixed_newton(prob: FastMPCProblem,
                            horizon: int) -> FixedNewtonOperator:
    """Build the constant operators, in the dtype of ``prob`` (the
    pipeline passes a float64 problem)."""
    T = horizon
    n = prob.A1.shape[-1]
    A1, A2, B = prob.A1, prob.A2, prob.B
    k = prob.barrier_k

    u0 = (prob.u_min + prob.u_max) / 2.0
    d_hi = 1.0 / (prob.u_max - u0)
    d_lo = 1.0 / (u0 - prob.u_min)
    pu0 = 1.0 / (2.0 * prob.r_diag + k * (d_hi ** 2 + d_lo ** 2))
    px = 1.0 / (2.0 * _q_stack(prob, T))

    W0 = (B * pu0) @ B.T
    px1 = _shift_down(px, 1)
    px2 = _shift_down(px, 2)
    eye = torch.eye(n, dtype=B.dtype, device=B.device)
    diag_blocks = (W0 + eye * px[:, None, :]
                   + (A1 * px1[:, None, :]) @ A1.T
                   + (A2 * px2[:, None, :]) @ A2.T)             # (T, n, n)
    sub1_blocks = -A1 * px1[:, None, :] + (A2 * px2[:, None, :]) @ A1.T
    sub2_blocks = -A2 * px2[:, None, :]
    S = torch.zeros((T, n, T, n), dtype=B.dtype, device=B.device)
    for i in range(T):
        S[i, :, i, :] = diag_blocks[i]
        if i >= 1:
            S[i, :, i - 1, :] = sub1_blocks[i]
            S[i - 1, :, i, :] = sub1_blocks[i].T
        if i >= 2:
            S[i, :, i - 2, :] = sub2_blocks[i]
            S[i - 2, :, i, :] = sub2_blocks[i].T
    neg_s_inv = -torch.linalg.inv(S.reshape(T * n, T * n))
    return FixedNewtonOperator(neg_s_inv=neg_s_inv, pu0=pu0, px=px)


def solve_fixed(prob: FastMPCProblem, op: FixedNewtonOperator, x0, x0_pre,
                w, horizon: int) -> SolverState:
    """Single-Newton-step solve via the precomputed operators and the
    line search, batched over the leading dims of x0 (..., n), x0_pre and
    w (..., T*n)."""
    T = horizon
    n = prob.A1.shape[-1]
    b = equality_rhs(prob, x0, x0_pre, w, horizon)             # (..., T, n)
    state = init_state(prob, horizon)
    dnu = (b.reshape(*b.shape[:-2], T * n) @ op.neg_s_inv.T
           ).reshape(b.shape)
    dU = (dnu @ prob.B) * op.pu0
    ct_dnu_x = (dnu - _shift_up(dnu, 1) @ prob.A1
                - _shift_up(dnu, 2) @ prob.A2)
    dX = -ct_dnu_x * op.px
    return line_search_step(prob, b, state, (dU, dX, dnu))
