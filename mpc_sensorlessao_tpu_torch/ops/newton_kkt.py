"""Batched fixed-barrier infeasible-start Newton KKT solves ("fastMPC")
(port of ``mpc_sensorlessao_tpu/ops/newton_kkt.py``; reference:
Fast_MPC/VAR_2/{inf_newton_solver.m, fast_mpc_*.m}).

  minimize  z'Hz + g'z + k * sum(-log(h - Pz))   s.t.  Cz = b

with z = (u_0, x_1, u_1, x_2, ..., u_{T-1}, x_T), a fixed number of
infeasible-start Newton steps from the midpoint init, barrier k fixed.
State is kept as (..., T, m) control / (..., T, n) state tensors with
any leading batch dims, so a whole scenario batch is one set of matmuls.
The primal Hessian Phi is handled blockwise (stage-block-diagonal for
box rows) and the dual Schur complement S = C Phi^-1 C' is assembled as
a block-banded matrix (n x n blocks, bandwidth = VAR order): one dense
Cholesky for short horizons, block cyclic reduction
(ops/block_tridiag.py) from CR_MIN_HORIZON on.  With the VAR_1 ramp
rows (``ramp=True``) the u-part of Phi is a per-coordinate tridiagonal
across stages.  The backtracking line search is a fixed bank of 16
candidate steps evaluated at once: without ramp rows from the residuals'
affine structure (the linear maps once on the state and once on the
direction), the bank scored by kernel L1 (csrc/line_search.cu).

In the real-time mode (one Newton step) the step collapses to
precomputed linear maps (``FixedNewtonOperator``, ``solve_fixed``).
"""

from __future__ import annotations

import ctypes
import dataclasses
from dataclasses import dataclass
from typing import NamedTuple

import torch

from . import block_tridiag, cuda_build

# Horizon at which the Schur solve switches from one dense Cholesky to
# block cyclic reduction (O(log T) depth, O(T n^3) work); the dense
# factorization is O(T^3 n^3).
CR_MIN_HORIZON = 16


@dataclass(frozen=True)
class FastMPCProblem:
    """Static problem data shared by every scenario.

    A1, A2: (n, n) VAR coefficients (A2 zeros for VAR(1)); B: (n, m) modal
    influence; q_diag, qf_diag: (n,) stage / terminal state cost
    diagonals; r_diag: (m,) control cost diagonal; u_min, u_max: (m,)
    box; barrier_k: 0-d log-barrier parameter.  Ramp-rate rows
    (VAR_1/fast_mpc_ineq_const.m:58-76), used only with ``ramp=True``:
    du_min <= u_t - u_{t-1} <= du_max with u_{-1} = u_prev; du_min,
    du_max: (m,); u_prev: (m,) or (..., m), one per scenario (the loop
    passes its running command).
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


def init_state(prob: FastMPCProblem, horizon: int,
               ramp: bool = False) -> SolverState:
    """Strictly feasible init.

    Box only: midpoints (fast_mpc_init.m:19-27); the inactive x box
    (README.md:538) gives X=0.  With ramp rows the midpoint is infeasible
    whenever |u_prev| > du_max (the reference's VAR_1 init ignores ramp
    rows), so U starts at u_prev (zero increments) clipped strictly inside
    the box, one row per scenario of u_prev.
    """
    m = prob.u_min.shape[-1]
    n = prob.A1.shape[-1]
    u_base = (ramp_start(prob.u_prev, prob.u_min, prob.u_max) if ramp
              else (prob.u_min + prob.u_max) / 2.0)
    u0 = u_base.unsqueeze(-2).expand(*u_base.shape[:-1], horizon, m)
    zeros = torch.zeros((horizon, n), dtype=u0.dtype, device=u0.device)
    return SolverState(U=u0, X=zeros, nu=zeros)


def ramp_start(u_prev, u_min, u_max):
    """The ramp-feasible start: u_prev clipped to 1e-3 of the box width
    inside the box."""
    margin = 1e-3 * (u_max - u_min)
    return torch.clamp(u_prev, u_min + margin, u_max - margin)


def _ramp_slacks(prob: FastMPCProblem, U):
    """(hi, lo) ramp slacks per stage: the stage-t row covers u_t - u_{t-1}
    with u_{-1} = u_prev (VAR_1/fast_mpc_ineq_const.m:58-76)."""
    first = U[..., :1, :] - prob.u_prev.unsqueeze(-2)
    rest = U[..., 1:, :] - U[..., :-1, :]
    dU = torch.cat([first, rest.expand(*first.shape[:-2], *rest.shape[-2:])],
                   dim=-2)
    return prob.du_max - dU, dU - prob.du_min


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


def residuals(prob: FastMPCProblem, b, state: SolverState,
              ramp: bool = False):
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
    if ramp:
        # the stage-t ramp row has +I on u_t, -I on u_{t-1}
        r_hi, r_lo = _ramp_slacks(prob, U)
        s = 1.0 / r_hi - 1.0 / r_lo
        rd_u = rd_u + k * (s - _shift_up(s, 1))
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


def _schur_x_blocks(prob: FastMPCProblem, px):
    """The x-part of the block-banded S = C Phi^-1 C' from 1/Phi_x ``px``
    (T, n): (diag, sub1, sub2) blocks (T, n, n), S[i, i], S[i, i-1] and
    S[i, i-2]; the u-part B Phi_u^-1 B' is added by the caller."""
    A1, A2 = prob.A1, prob.A2
    px1 = _shift_down(px, 1)                                    # px_{i-1}
    px2 = _shift_down(px, 2)
    eye = torch.eye(px.shape[-1], dtype=px.dtype, device=px.device)
    diag = (eye * px[:, None, :] + (A1 * px1[:, None, :]) @ A1.T
            + (A2 * px2[:, None, :]) @ A2.T)
    sub1 = -A1 * px1[:, None, :] + (A2 * px2[:, None, :]) @ A1.T
    sub2 = -A2 * px2[:, None, :]
    return diag, sub1, sub2


def _dense_banded(diag, sub1, sub2):
    """The dense symmetric (..., T*n, T*n) matrix of a bandwidth-2 block
    band: diag (..., T, n, n) S[i, i], sub1/sub2 (T, n, n) S[i, i-1] and
    S[i, i-2]."""
    T, n = diag.shape[-3], diag.shape[-1]
    S = torch.zeros((*diag.shape[:-3], T, T, n, n), dtype=diag.dtype,
                    device=diag.device)
    i = torch.arange(T, device=diag.device)
    S[..., i, i, :, :] = diag
    for k, sub in ((1, sub1), (2, sub2)):
        j = i[k:]
        S[..., j, j - k, :, :] = sub[j]
        S[..., j - k, j, :, :] = sub[j].mT
    return S.transpose(-3, -2).reshape(*diag.shape[:-3], T * n, T * n)


def newton_direction(prob: FastMPCProblem, b, state: SolverState,
                     ramp: bool = False):
    """One Newton direction (inf_newton_solver.m:24-35), batched over the
    leading dims of ``b`` and ``state``:

      Phi_u = 2R + k diag(d_hi^2 + d_lo^2)  (diagonal per stage; with ramp
              rows a per-coordinate T x T tridiagonal across stages),
      Phi_x[t] = 2 Q_t                      (diagonal),
      S = C Phi^-1 C'  block-banded, bandwidth 2 (VAR(2)).

    The ramp rows make the u-part of S dense in the stage index: the
    (..., T, T, n, n) term M[i, j] = B diag(Phi_u^-1[:, i, j]) B' takes
    B T^2 n^2 floats (1.1 GB at B=64, T=32, n=65; the loop runs ramp rows
    at N=2).  Without ramp rows S goes to one dense Cholesky below
    CR_MIN_HORIZON and to block cyclic reduction from it on.  A failed
    Cholesky gives NaN to its own scenario only.
    """
    U, X, nu = state
    T, m = U.shape[-2:]
    n = X.shape[-1]
    k = prob.barrier_k
    B = prob.B

    d_hi = 1.0 / (prob.u_max - U)
    d_lo = 1.0 / (U - prob.u_min)
    phi_u = 2.0 * prob.r_diag + k * (d_hi ** 2 + d_lo ** 2)   # (..., T, m)
    px = 1.0 / (2.0 * _q_stack(prob, T))                       # (T, n)

    rd_u, rd_x, rp = residuals(prob, b, state, ramp=ramp)

    if ramp:
        # the stage-t ramp rows contribute w_t (e_t - e_{t-1})(e_t -
        # e_{t-1})' with w_t = 1/hi_t^2 + 1/lo_t^2 (stage 0: e_0 e_0')
        r_hi, r_lo = _ramp_slacks(prob, U)
        w = 1.0 / r_hi ** 2 + 1.0 / r_lo ** 2                  # (..., T, m)
        diag_c = (phi_u + k * (w + _shift_up(w, 1))).mT        # (..., m, T)
        off_c = (-k * w[..., 1:, :]).mT                        # (..., m, T-1)
        Phi_u = (torch.diag_embed(diag_c) + torch.diag_embed(off_c, 1)
                 + torch.diag_embed(off_c, -1))                # (..., m, T, T)
        Ginv, info = torch.linalg.inv_ex(Phi_u)
        Ginv = torch.where((info != 0)[..., None, None], torch.nan, Ginv)

        def u_solve(v):                                        # (..., T, m)
            return torch.einsum("...mts,...sm->...tm", Ginv, v)

        M = torch.einsum("nm,...mij,km->...ijnk", B, Ginv, B)
    else:
        pu = 1.0 / phi_u

        def u_solve(v):
            return v * pu

        W = torch.einsum("nm,...tm,km->...tnk", B, pu, B)      # (..., T, n, n)

    # C Phi^-1 rd (row i)
    ru = u_solve(rd_u)
    rx = rd_x * px
    c_phinv_rd = (-ru @ B.T + rx - _shift_down(rx, 1) @ prob.A1.T
                  - _shift_down(rx, 2) @ prob.A2.T)
    beta = -rp + c_phinv_rd                                    # (..., T, n)
    batch = beta.shape[:-2]

    diag, sub1, sub2 = _schur_x_blocks(prob, px)
    if not ramp:
        diag = diag + W
    if not ramp and T >= CR_MIN_HORIZON:
        # long horizons: block cyclic reduction on the banded system
        full = (*batch, T, n, n)
        dnu = -block_tridiag.banded_solve(diag.expand(full), sub1.expand(full),
                                          sub2.expand(full), beta)
    else:
        S = _dense_banded(diag, sub1, sub2)
        if ramp:
            S = S + M.transpose(-3, -2).reshape(*M.shape[:-4], T * n, T * n)
        dnu = -block_tridiag.cho_solve(
            block_tridiag.cho_factor(S),
            beta.reshape(*batch, T * n, 1)).reshape(*batch, T, n)

    # dz = Phi^-1 (-rd - C' dnu)
    dU = u_solve(-rd_u + dnu @ B)
    ct_dnu_x = dnu - _shift_up(dnu, 1) @ prob.A1 - _shift_up(dnu, 2) @ prob.A2
    dX = (-rd_x - ct_dnu_x) * px
    return dU, dX, dnu


# line search: Armijo-style decrease factor, backtracking ratio, bank size
LS_ALPHA = 1e-4
LS_BETA = 0.5
LS_CANDIDATES = 16


def line_search_terms(prob: FastMPCProblem, b, state: SolverState,
                      direction):
    """The data of the line search without ramp rows, as kernel L1 takes
    it: (U, dU, a_u, l_u, a_x, l_x, a_p, l_p), each (B, T, .) and
    contiguous over the flattened batch of ``b``, ``state`` and
    ``direction``, such that the residuals at the candidate
    state + t direction are

      rd_u(t) = a_u + t l_u + k (1/(u_max - U - t dU) - 1/(U + t dU - u_min)),
      rd_x(t) = a_x + t l_x,    rp(t) = a_p + t l_p.

    The residuals' linear maps run once on the state, at its own batch
    shape (one (T, .) row for every scenario in ``solve_fixed``), and once
    on the direction: three GEMMs each -- nu against -[B | A1 | A2], X
    against -[A1' | A2'], U against B' -- with the stage shifts taken on
    the products."""
    n, m = prob.B.shape
    T = b.shape[-2]
    w_nu = -torch.cat([prob.B, prob.A1, prob.A2], dim=1)       # (n, m+2n)
    w_x = -torch.cat([prob.A1.T, prob.A2.T], dim=1)            # (n, 2n)
    r2, q2 = 2.0 * prob.r_diag, 2.0 * _q_stack(prob, T)

    def linear(U, X, nu):
        """(2 R u - B' nu_t, rd_x, rp + b) at (U, X, nu)."""
        nu_w, x_w = nu @ w_nu, X @ w_x
        l_u = torch.addcmul(nu_w[..., :m], r2, U)
        l_x = torch.addcmul(nu, q2, X)
        l_x[..., :-1, :] += nu_w[..., 1:, m:m + n]             # -A1' nu_{t+1}
        l_x[..., :-2, :] += nu_w[..., 2:, m + n:]              # -A2' nu_{t+2}
        l_p = X - U @ prob.B.T
        l_p[..., 1:, :] += x_w[..., :-1, :n]                   # -A1 x_{t-1}
        l_p[..., 2:, :] += x_w[..., :-2, n:]                   # -A2 x_{t-2}
        return l_u, l_x, l_p

    a_u, a_x, a_p = linear(*state)
    l_u, l_x, l_p = linear(*direction)
    terms = (state.U, direction[0], a_u, l_u, a_x, l_x, a_p - b, l_p)
    batch = torch.broadcast_shapes(*(v.shape[:-2] for v in terms))
    return tuple(v.expand(*batch, *v.shape[-2:]).reshape(-1, *v.shape[-2:])
                 .contiguous() for v in terms)


def line_search_bank_ref(U, dU, a_u, l_u, a_x, l_x, a_p, l_p, u_min, u_max,
                         barrier_k):
    """Plain PyTorch version of kernel L1 on ``line_search_terms``' data,
    any leading dims, device and dtype: the residual norm at t = 0 and at
    each t of the bank, (..., 17), and the first candidate whose norm is
    at most (1 - LS_ALPHA t) times t = 0's and whose controls stay
    strictly inside the box -- else the smallest step -- as its index
    (...,) and its t (...,)."""
    ts = LS_BETA ** torch.arange(LS_CANDIDATES, dtype=U.dtype,
                                 device=U.device)
    tc = torch.cat([ts.new_zeros(1), ts])[:, None, None]       # (17, 1, 1)

    def at(a, l):
        return a.unsqueeze(-3) + tc * l.unsqueeze(-3)          # (..., 17, T, .)

    u = at(U, dU)
    rd_u = at(a_u, l_u) + barrier_k * (1.0 / (u_max - u) - 1.0 / (u - u_min))
    norms = residual_norm(rd_u, at(a_x, l_x), at(a_p, l_p))
    inside = ((u < u_max) & (u > u_min)).all(dim=(-2, -1))[..., 1:]
    oks = (norms[..., 1:] <= (1.0 - LS_ALPHA * ts) * norms[..., :1]) & inside
    # the first accepted candidate (argmax of the int cast picks the
    # first True), else the smallest step
    idx = torch.where(oks.any(dim=-1), torch.argmax(oks.to(torch.int8), dim=-1),
                      LS_CANDIDATES - 1)
    return idx, ts[idx], norms


def line_search_bank(U, dU, a_u, l_u, a_x, l_x, a_p, l_p, u_min, u_max,
                     barrier_k):
    """Kernel L1: ``line_search_bank_ref`` in one pass over each
    scenario's data (csrc/line_search.cu).  U, dU, a_u, l_u (B, T, m) and
    a_x, l_x, a_p, l_p (B, T, n); u_min, u_max (m,) and the 0-d
    barrier_k; all float32, or all float64, contiguous and on one CUDA
    device.  Returns the picked index (B,) int32, its t (B,) and the norms
    (B, 17) in the data's dtype, counted in ``line_search_bank.launches``.
    It raises on anything else.  The norms are the plain version's but
    for the order of their sums."""
    dev = dU.device
    if dev.type != "cuda":
        raise ValueError(f"line_search_bank runs on a CUDA device, got {dev}")
    if dU.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"dU must be torch.float32 or torch.float64, got "
                        f"{dU.dtype}")
    if dU.dim() != 3:
        raise ValueError(f"dU must be (B, T, m), got {tuple(dU.shape)}")
    B, T, m = dU.shape
    n = a_x.shape[-1]
    for label, v, shape in (
            ("U", U, (B, T, m)), ("dU", dU, (B, T, m)),
            ("a_u", a_u, (B, T, m)), ("l_u", l_u, (B, T, m)),
            ("a_x", a_x, (B, T, n)), ("l_x", l_x, (B, T, n)),
            ("a_p", a_p, (B, T, n)), ("l_p", l_p, (B, T, n)),
            ("u_min", u_min, (m,)), ("u_max", u_max, (m,)),
            ("barrier_k", barrier_k, ())):
        if v.device != dev:
            raise ValueError(f"{label} is on {v.device}, expected {dev}")
        if v.dtype != dU.dtype:
            raise TypeError(f"{label} must be {dU.dtype}, got {v.dtype}")
        if tuple(v.shape) != shape:
            raise ValueError(f"{label} has shape {tuple(v.shape)}, "
                             f"expected {shape}")
        if not v.is_contiguous():
            raise ValueError(f"{label} must be contiguous")
    ts = LS_BETA ** torch.arange(LS_CANDIDATES, dtype=dU.dtype, device=dev)
    norms = torch.empty((B, LS_CANDIDATES + 1), dtype=dU.dtype, device=dev)
    idx = torch.empty((B,), dtype=torch.int32, device=dev)
    t = torch.empty((B,), dtype=dU.dtype, device=dev)
    launch = cuda_build.function(
        "line_search", [ctypes.c_void_p] * 12 + [ctypes.c_double]
        + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 3
        + [ctypes.c_int, ctypes.c_void_p])
    launch(*(v.data_ptr() for v in (U, dU, a_u, l_u, a_x, l_x, a_p, l_p,
                                    u_min, u_max, barrier_k, ts)),
           LS_ALPHA, int(dU.dtype == torch.float64), B, T, m, n,
           *(v.data_ptr() for v in (norms, idx, t)),
           dev.index, torch.cuda.current_stream(dev).cuda_stream)
    line_search_bank.launches += 1
    return idx, t, norms


line_search_bank.launches = 0


def line_search_step(prob, b, state, direction, ramp: bool = False):
    """Parallel-candidate norm-descent backtracking.

    A fixed bank t in {1, beta, ..., beta^15}: accept the largest t whose
    residual norm satisfies the Armijo-style decrease AND keeps the
    control strictly inside its box -- and, with ramp rows, every ramp
    slack positive -- per scenario (replaces the sequential loop of
    backtracking_inf_newton.m:3-9); if none is accepted, take the
    smallest step.  Without ramp rows the residuals are affine in t but
    for the barrier (``line_search_terms``), and the bank is scored by
    kernel L1 on CUDA tensors, by its plain version on the CPU; with them
    every candidate's residuals are evaluated in full.
    """
    if ramp:
        return _ramp_line_search_step(prob, b, state, direction)
    terms = line_search_terms(prob, b, state, direction)
    batch = torch.broadcast_shapes(
        b.shape[:-2], *(v.shape[:-2] for v in (*state, *direction)))
    bank = line_search_bank if terms[1].is_cuda else line_search_bank_ref
    _, t, _ = bank(*terms, prob.u_min, prob.u_max, prob.barrier_k)
    t = t.reshape(*batch, 1, 1)
    return SolverState(*(torch.addcmul(v, t, dv)
                         for v, dv in zip(state, direction)))


def _ramp_line_search_step(prob, b, state, direction):
    """``line_search_step`` with ramp rows: the 16 candidate states as
    (..., C, T, .) tensors through the full ``residuals``."""
    dU, dX, dnu = direction
    base = residual_norm(*residuals(prob, b, state, ramp=True))  # (...)
    ts = LS_BETA ** torch.arange(LS_CANDIDATES, dtype=dU.dtype,
                                 device=dU.device)
    tc = ts[:, None, None]                                      # (C, 1, 1)

    def at(x, dx, t):
        return x.unsqueeze(-3) + t * dx.unsqueeze(-3)

    # candidates ride a new dim before the stage dim: (..., C, T, .)
    cand = SolverState(at(state.U, dU, tc), at(state.X, dX, tc),
                       at(state.nu, dnu, tc))
    cprob = dataclasses.replace(prob, u_prev=prob.u_prev.unsqueeze(-2))
    norm = residual_norm(*residuals(cprob, b.unsqueeze(-3), cand, ramp=True))
    r_hi, r_lo = _ramp_slacks(cprob, cand.U)
    feasible = ((cand.U < prob.u_max).all(dim=(-2, -1))
                & (cand.U > prob.u_min).all(dim=(-2, -1))
                & (r_hi > 0).all(dim=(-2, -1)) & (r_lo > 0).all(dim=(-2, -1)))
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
    B = prob.B
    k = prob.barrier_k

    u0 = (prob.u_min + prob.u_max) / 2.0
    d_hi = 1.0 / (prob.u_max - u0)
    d_lo = 1.0 / (u0 - prob.u_min)
    pu0 = 1.0 / (2.0 * prob.r_diag + k * (d_hi ** 2 + d_lo ** 2))
    px = 1.0 / (2.0 * _q_stack(prob, T))

    diag, sub1, sub2 = _schur_x_blocks(prob, px)
    S = _dense_banded(diag + (B * pu0) @ B.T, sub1, sub2)
    return FixedNewtonOperator(neg_s_inv=-torch.linalg.inv(S), pu0=pu0,
                               px=px)


def solve_fixed(prob: FastMPCProblem, op: FixedNewtonOperator, x0, x0_pre,
                w, horizon: int) -> SolverState:
    """Single-Newton-step solve via the precomputed operators and the
    line search, batched over the leading dims of x0 (..., n), x0_pre and
    w (..., T*n)."""
    b = equality_rhs(prob, x0, x0_pre, w, horizon)             # (..., T, n)
    return line_search_step(prob, b, init_state(prob, horizon),
                            fixed_newton_direction(prob, op, b))


def fixed_newton_direction(prob: FastMPCProblem, op: FixedNewtonOperator,
                           b):
    """(dU, dX, dnu) from the midpoint init for the stacked equality rhs
    ``b`` (..., T, n), through the precomputed operators."""
    dnu = (b.reshape(*b.shape[:-2], -1) @ op.neg_s_inv.T).reshape(b.shape)
    dU = (dnu @ prob.B) * op.pu0
    ct_dnu_x = (dnu - _shift_up(dnu, 1) @ prob.A1
                - _shift_up(dnu, 2) @ prob.A2)
    return dU, -ct_dnu_x * op.px, dnu


def solve(prob: FastMPCProblem, x0, x0_pre, w, horizon: int,
          n_newton: int = 1, ramp: bool = False) -> SolverState:
    """Fixed-barrier fixed-Newton solve (= mpc_fixed_log_newton,
    Fast_MPC2.m:124-130), every step line-searched, batched over the
    leading dims of x0 (..., n), x0_pre, w (..., T*n) and prob.u_prev.
    ``ramp=True`` activates the VAR_1 ramp-rate rows
    (VAR_1/fast_mpc_ineq_const.m:58-76) with prob.du_min/du_max/u_prev."""
    b = equality_rhs(prob, x0, x0_pre, w, horizon)
    state = init_state(prob, horizon, ramp=ramp)
    for _ in range(n_newton):
        state = line_search_step(prob, b, state,
                                 newton_direction(prob, b, state, ramp=ramp),
                                 ramp=ramp)
    return state


def solve_barrier_continuation(prob: FastMPCProblem, x0, x0_pre, w,
                               horizon: int, k_start: float = 1.0,
                               mu: float = 0.1, k_min_scaled: float = 1e-2,
                               n_newton_inner: int = 20) -> SolverState:
    """Barrier continuation k <- mu k until k*len(z) < k_min_scaled
    (= mpc_fixed_newton / mpc_solve_full, Fast_MPC2.m:100-115,131-144),
    on a static schedule of k values, n_newton_inner line-searched Newton
    steps at each; batched as ``solve``."""
    m = prob.u_min.shape[-1]
    n = prob.A1.shape[-1]
    z_len = horizon * (n + m)
    ks = []
    k = k_start
    while k * z_len >= k_min_scaled:
        ks.append(k)
        k *= mu
    b = equality_rhs(prob, x0, x0_pre, w, horizon)
    state = init_state(prob, horizon)
    for k in ks:
        p = dataclasses.replace(prob, barrier_k=torch.tensor(
            k, dtype=state.U.dtype, device=state.U.device))
        for _ in range(n_newton_inner):
            state = line_search_step(p, b, state,
                                     newton_direction(p, b, state))
    return state
