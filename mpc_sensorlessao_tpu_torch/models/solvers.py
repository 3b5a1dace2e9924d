"""MPC solver backends (port of ``mpc_sensorlessao_tpu/models/solvers.py``):

* ``closed_form``   -- U = closed_form_matrix @ r (one matmul, README.md:417);
* ``fastmpc``       -- the structured batched Newton-KKT solve
                       (ops.newton_kkt), built here by
                       ``make_fastmpc_problem``;
* ``assemble_dense`` / ``dense_newton_solve`` -- the literal dense
                       assembly of the stacked problem (the MATLAB
                       z-interleaved layout), a cross-check oracle that
                       also takes the VAR_1 ramp rows;
* ``admm_condensed`` -- fixed-iteration ADMM on the condensed box + ramp
                       QP (the CVX replacement: the constraint set of
                       README.md:512-517);
* ``geninv``        -- the reference's full-rank-Cholesky pseudo-inverse.

Every function is batched over the leading dims of its per-scenario
tensors; the operators are shared.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch

from ..ops import newton_kkt
from ..ops.block_tridiag import cho_factor, cho_solve
from . import mpc
from .mpc import MPCMatrices


def closed_form(mats: MPCMatrices, r: torch.Tensor) -> torch.Tensor:
    """Unconstrained minimizer of U'HU + r'U; batched over leading dims."""
    return r @ mats.closed_form.T


# geninv's rank tolerance, relative to the smallest positive diagonal of A
GENINV_TOL = 1e-9


def geninv(G: torch.Tensor) -> torch.Tensor:
    """Moore-Penrose inverse via full-rank Cholesky (Courrieu 2008), of
    each (m, n) matrix of G (..., m, n).

    Port of the reference's ``geninv`` timing variant (main.mlx CDATA
    15): A = G'G (or GG'), a full-rank Cholesky L whose rank-deficient
    columns are zeroed (a fixed-shape column drop), then
    Y = L (L'L)^+2 L' G'.  Full-rank inputs match MATLAB's result.
    """
    m, n = G.shape[-2:]
    transpose = m < n
    A = (G @ G.mT) if transpose else (G.mT @ G)
    k = A.shape[-1]
    dA = torch.diagonal(A, dim1=-2, dim2=-1)
    tol = torch.where(dA > 0, dA, torch.inf).amin(dim=-1) * GENINV_TOL
    rows = torch.arange(k, device=G.device)
    L = torch.zeros_like(A)
    for j in range(k):
        col = A[..., :, j] - (L @ L[..., j, :, None])[..., 0]
        piv = col[..., j]
        good = (piv > tol)[..., None]
        denom = torch.sqrt(torch.where(good[..., 0], piv, 1.0))[..., None]
        L[..., :, j] = torch.where(good, col / denom, 0.0) * (rows >= j)
    M = mpc.pinv(L.mT @ L)
    core = L @ M @ M @ L.mT
    return (G.mT @ core) if transpose else (core @ G.mT)


# ---------------------------------------------------------------------------
# dense stacked fastMPC (oracle; literal MATLAB layout)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class DenseProblem:
    """Dense stacked-z problem: min z'Hz + g'z + k*(-sum log(h-Pz))
    s.t. Cz = b (Fast_MPC2's assembly).  H, g, P, C are shared; b, h and
    z_init carry the scenario dims of the assembly's inputs."""

    H: torch.Tensor
    g: torch.Tensor
    P: torch.Tensor
    h: torch.Tensor
    C: torch.Tensor
    b: torch.Tensor
    z_init: torch.Tensor
    barrier_k: torch.Tensor


def assemble_dense(Q, R, Qf, A1, A2, B, w, x0, x0_pre, u_prev,
                   u_min, u_max, du_min, du_max, horizon: int,
                   ramp: bool, barrier_k: float) -> DenseProblem:
    """The literal stacked assembly, batched over the leading dims of w
    (..., T*n), x0, x0_pre (..., n) and u_prev (..., m).

    Layout z = (u_0, x_1, u_1, x_2, ...) (fast_mpc_objective.m:50-55);
    equality rows per fast_mpc_eq_const.m:38-46 (VAR(1): pass A2=0);
    inequality = box rows (fast_mpc_ineq_const.m:42-56) plus, when
    ``ramp``, the VAR_1 ramp rows (VAR_1/fast_mpc_ineq_const.m:58-76).
    """
    n, m = B.shape
    T = horizon
    Z = T * (n + m)
    kw = dict(dtype=B.dtype, device=B.device)

    def u_off(t):
        return t * (n + m)

    def x_off(t):  # x_{t+1}
        return t * (n + m) + m

    H = torch.zeros((Z, Z), **kw)
    for t in range(T):
        H[u_off(t):u_off(t) + m, u_off(t):u_off(t) + m] = R
        Qt = Qf if t == T - 1 else Q
        H[x_off(t):x_off(t) + n, x_off(t):x_off(t) + n] = Qt
    g = torch.zeros((Z,), **kw)

    C = torch.zeros((T * n, Z), **kw)
    eye_n = torch.eye(n, **kw)
    w = w.reshape(*w.shape[:-1], T, n)
    rows_b = []
    for i in range(T):
        C[i * n:(i + 1) * n, u_off(i):u_off(i) + m] = -B
        C[i * n:(i + 1) * n, x_off(i):x_off(i) + n] = eye_n
        if i >= 1:
            C[i * n:(i + 1) * n, x_off(i - 1):x_off(i - 1) + n] = -A1
        if i >= 2:
            C[i * n:(i + 1) * n, x_off(i - 2):x_off(i - 2) + n] = -A2
        bi = w[..., i, :]
        if i == 0:
            bi = bi + x0 @ A1.T + x0_pre @ A2.T
        elif i == 1:
            bi = bi + x0 @ A2.T
        rows_b.append(bi)
    b = torch.cat(torch.broadcast_tensors(*rows_b), dim=-1)

    eye_m = torch.eye(m, **kw)
    n_rows = 2 * m * T * (2 if ramp else 1)
    P = torch.zeros((n_rows, Z), **kw)
    for t in range(T):
        P[2 * m * t:2 * m * t + m, u_off(t):u_off(t) + m] = eye_m
        P[2 * m * t + m:2 * m * (t + 1), u_off(t):u_off(t) + m] = -eye_m
    rows_h = [torch.cat([u_max, -u_min])] * T
    if ramp:
        for t in range(T):
            r0 = 2 * m * (T + t)
            P[r0:r0 + m, u_off(t):u_off(t) + m] = eye_m
            P[r0 + m:r0 + 2 * m, u_off(t):u_off(t) + m] = -eye_m
            if t == 0:
                rows_h.append(torch.cat([u_prev + du_max,
                                         -u_prev - du_min], dim=-1))
            else:
                P[r0:r0 + m, u_off(t - 1):u_off(t - 1) + m] = -eye_m
                P[r0 + m:r0 + 2 * m, u_off(t - 1):u_off(t - 1) + m] = eye_m
                rows_h.append(torch.cat([du_max, -du_min]))
    h = torch.cat(torch.broadcast_tensors(*rows_h), dim=-1)

    # with ramp rows the ramp-feasible start of newton_kkt.init_state:
    # the reference's midpoint is infeasible when |u_prev| > du_max
    u_init = (newton_kkt.ramp_start(u_prev, u_min, u_max) if ramp
              else (u_min + u_max) / 2.0)
    z0 = torch.cat([u_init, torch.zeros((*u_init.shape[:-1], n), **kw)],
                   dim=-1)
    z0 = z0.unsqueeze(-2).expand(*z0.shape[:-1], T, n + m).reshape(
        *z0.shape[:-1], Z)
    return DenseProblem(H=H, g=g, P=P, h=h, C=C, b=b, z_init=z0,
                        barrier_k=torch.tensor(float(barrier_k), **kw))


def _dense_residuals(p: DenseProblem, z, nu, h, b):
    """(rd, rp, d) at z (..., Z), nu (..., T*n); h and b broadcast
    against them."""
    d = 1.0 / (h - z @ p.P.T)
    rd = 2.0 * z @ p.H.T + p.g + p.barrier_k * (d @ p.P) + nu @ p.C
    rp = z @ p.C.T - b
    return rd, rp, d


def dense_newton_solve(p: DenseProblem, n_newton: int = 1) -> torch.Tensor:
    """Infeasible-start Newton on the dense problem
    (inf_newton_solver.m:1-43), deterministic nu=0 init, the same
    candidate-bank line search as the structured solver; batched over the
    scenario dims of b, h and z_init.  Returns z (..., Z)."""
    z = p.z_init
    nu = torch.zeros_like(p.b)
    ts = newton_kkt.LS_BETA ** torch.arange(
        newton_kkt.LS_CANDIDATES, dtype=z.dtype, device=z.device)
    for _ in range(n_newton):
        rd, rp, d = _dense_residuals(p, z, nu, p.h, p.b)
        Phi = 2.0 * p.H + p.barrier_k * (p.P.T * (d ** 2)[..., None, :]) @ p.P
        chol = cho_factor(Phi)
        schur = p.C @ cho_solve(chol, p.C.T)
        phinv_rd = cho_solve(chol, rd[..., None])[..., 0]
        beta = -rp + phinv_rd @ p.C.T
        dnu = cho_solve(cho_factor(schur), -beta[..., None])[..., 0]
        dz = cho_solve(chol, (-rd - dnu @ p.C)[..., None])[..., 0]

        base = torch.sqrt(torch.sum(rd ** 2, dim=-1)
                          + torch.sum(rp ** 2, dim=-1))
        # candidates ride a new dim before the last: (..., C, .)
        zc = z.unsqueeze(-2) + ts[:, None] * dz.unsqueeze(-2)
        nc = nu.unsqueeze(-2) + ts[:, None] * dnu.unsqueeze(-2)
        h_c = p.h.unsqueeze(-2)
        slack_ok = (h_c - zc @ p.P.T > 0).all(dim=-1)
        rdc, rpc, _ = _dense_residuals(p, zc, nc, h_c, p.b.unsqueeze(-2))
        norm = torch.sqrt(torch.sum(rdc ** 2, dim=-1)
                          + torch.sum(rpc ** 2, dim=-1))
        oks = ((norm <= (1 - newton_kkt.LS_ALPHA * ts) * base[..., None])
               & slack_ok)
        idx = torch.argmax(oks.to(torch.int8), dim=-1)
        t = torch.where(oks.any(dim=-1), ts[idx], ts[-1])[..., None]
        z, nu = z + t * dz, nu + t * dnu
    return z


def unpack_controls(z: torch.Tensor, n: int, m: int, horizon: int):
    """z (..., Z) -> (U (..., T, m), X (..., T, n)) (the unpack loop,
    README.md:558-568)."""
    zz = z.reshape(*z.shape[:-1], horizon, n + m)
    return zz[..., :m], zz[..., m:]


# ---------------------------------------------------------------------------
# ADMM on the condensed box+ramp QP (CVX-equivalent backend)
# ---------------------------------------------------------------------------

class ADMMInfo(NamedTuple):
    """Convergence telemetry per scenario (rms over constraint rows).

    primal_rms: rms of [U - z1; EU - z2] (constraint violation of the
                consensus split);
    dual_rms:   rms of rho [z1 - z1_prev; E'(z2 - z2_prev)] (stationarity);
    converged:  both below tol (False when tol is None -- nothing was
                requested, nothing is claimed).
    """

    primal_rms: torch.Tensor
    dual_rms: torch.Tensor
    rho: torch.Tensor
    converged: torch.Tensor


def admm_condensed(mats: MPCMatrices, r, U_min, U_max, dU_min, dU_max,
                   rho: float | None = None, n_iter: int = 400,
                   tol: float | None = None, adapt_rounds: int = 0,
                   return_info: bool = False):
    """min U'HU + r'U  s.t. U_min <= U <= U_max, dU_min <= E U <= dU_max
    (the CVX problem, README.md:512-518), by two-block ADMM with a
    Cholesky factor computed once per round; batched over the leading
    dims of r and the bounds ((..., N*nu) or (N*nu,)), one problem per
    scenario.

    ``rho`` defaults to the mean curvature scale trace(2H)/Z.
    ``adapt_rounds`` > 0 splits the budget into rounds with per-scenario
    residual-balancing rho updates between them (rho *= sqrt(primal /
    dual), clipped to [0.1, 10]; each round refactors M = 2H + rho(I +
    E'E), per scenario once rho differs).  Only the last iteration of a
    round computes its residuals: nothing reads the others.
    ``return_info=True`` also returns :class:`ADMMInfo`; with ``tol``
    set, converged = primal_rms < tol and dual_rms < tol, per scenario.
    """
    E, H = mats.E, mats.H
    Z = H.shape[-1]
    rho = (torch.trace(2.0 * H) / Z if rho is None
           else torch.tensor(float(rho), dtype=H.dtype, device=H.device))
    batch = torch.broadcast_shapes(r.shape, U_min.shape, U_max.shape,
                                   dU_min.shape, dU_max.shape)[:-1]
    eye_ete = torch.eye(Z, dtype=H.dtype, device=H.device) + E.T @ E

    def run(rho, state, n):
        rho_v = rho[..., None]                     # per-scenario or 0-d
        chol = cho_factor(2.0 * H + rho_v[..., None] * eye_ete)
        U, z1, z2, y1, y2, rp, rd = state
        for it in range(n):
            rhs = -r + rho_v * (z1 - y1) + (rho_v * (z2 - y2)) @ E
            if chol.dim() == 2:
                # one factor for every scenario: one solve with the
                # scenarios as its right-hand-side columns
                U = cho_solve(chol, rhs.reshape(-1, Z).T).T.reshape(
                    rhs.shape)
            else:
                U = cho_solve(chol, rhs[..., None])[..., 0]
            EU = U @ E.T
            z1n = torch.clamp(U + y1, U_min, U_max)
            z2n = torch.clamp(EU + y2, dU_min, dU_max)
            y1 = y1 + U - z1n
            y2 = y2 + EU - z2n
            if it == n - 1:
                rp = torch.sqrt((torch.sum((U - z1n) ** 2, dim=-1)
                                 + torch.sum((EU - z2n) ** 2, dim=-1))
                                / (2 * Z))
                rd = rho * torch.sqrt(
                    (torch.sum((z1n - z1) ** 2, dim=-1)
                     + torch.sum(((z2n - z2) @ E) ** 2, dim=-1)) / (2 * Z))
            z1, z2 = z1n, z2n
        return U, z1, z2, y1, y2, rp, rd

    U0 = torch.zeros((*batch, Z), dtype=H.dtype, device=H.device)
    zero = torch.zeros(batch, dtype=H.dtype, device=H.device)
    state = (U0, U0, U0 @ E.T, U0, U0 @ E.T, zero, zero)
    rounds = max(1, adapt_rounds + 1)
    per = max(1, n_iter // rounds)
    for k in range(rounds):
        state = run(rho, state, per)
        if k < rounds - 1:
            # residual balancing (Boyd et al. 2011 sect. 3.4.1); the
            # scaled duals y = lambda/rho are rescaled with rho
            U, z1, z2, y1, y2, rp, rd = state
            ratio = torch.sqrt((rp + 1e-12) / (rd + 1e-12))
            rho_new = rho * torch.clamp(ratio, 0.1, 10.0)
            s = (rho / rho_new)[..., None]
            state = (U, z1, z2, y1 * s, y2 * s, rp, rd)
            rho = rho_new
    U, _, _, _, _, rp, rd = state
    if not return_info:
        return U
    if tol is None:
        converged = torch.zeros(batch, dtype=torch.bool, device=H.device)
    else:
        converged = (rp < tol) & (rd < tol)
    return U, ADMMInfo(primal_rms=rp, dual_rms=rd,
                       rho=rho.expand(batch), converged=converged)


# ---------------------------------------------------------------------------
# structured fastMPC facade
# ---------------------------------------------------------------------------

def make_fastmpc_problem(A1, A2, B, q_weight, p_weight, r_weight, u_max,
                         barrier_k, du_max=0.0,
                         u_prev=None) -> newton_kkt.FastMPCProblem:
    """FastMPCProblem from reference-style scalar weights (README.md:344-356:
    Q=q*I, P=p*I, R=r*I, symmetric box), in the dtype and on the device
    of ``B``.  ``du_max``/``u_prev`` fill the VAR_1 ramp-row data (read
    only by solve(..., ramp=True))."""
    n, m = B.shape
    kw = dict(dtype=B.dtype, device=B.device)

    def full(v, size):
        return torch.full((size,), float(v), **kw)

    return newton_kkt.FastMPCProblem(
        A1=A1.to(**kw), A2=A2.to(**kw), B=B,
        q_diag=full(q_weight, n), qf_diag=full(p_weight, n),
        r_diag=full(r_weight, m),
        u_min=full(-u_max, m), u_max=full(u_max, m),
        barrier_k=torch.tensor(float(barrier_k), **kw),
        du_min=full(-du_max, m), du_max=full(du_max, m),
        u_prev=full(0.0, m) if u_prev is None else u_prev.to(**kw),
    )


def fastmpc(prob, x0, x0_pre, w, horizon: int, n_newton: int = 1):
    """Real-time solve; returns stacked U (..., horizon*m) like the
    reference's u_lgnw (README.md:558-570)."""
    state = newton_kkt.solve(prob, x0, x0_pre, w, horizon=horizon,
                             n_newton=n_newton)
    return state.U.reshape(*state.U.shape[:-2], -1)
