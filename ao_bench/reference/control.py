"""VAR identification, the fastMPC Newton step and the warm start, float64.

The controller is the reference's VAR(2) fastMPC (Fast_MPC/VAR_2): with
z = (u_0, x_1, u_1, x_2, ..., u_{N-1}, x_N),

  minimise  z'Hz - k sum log(h - Pz)  s.t.  Cz = b,

H = blkdiag(R, Q, ..., R, P) for R = r I, Q = q I and terminal P; the
box rows |u_t| < u_max; the equality rows x_{t+1} - A1 x_t - A2 x_{t-1}
- B u_t = b_t with b_0 = w_0 + A1 x0 + A2 x0_pre, b_1 = w_1 + A2 x0,
b_t = w_t beyond, w the reference offsets -M1 B u[k-1] - M2 B u[k-2]
of the condensed free response.  One infeasible-start Newton step from
the box midpoint (z = 0, dual 0) solves the KKT system written out
densely here, followed by the backtracking search over t = 1, 1/2, ...,
2^-15 on the residual norm with the Armijo factor 1 - 1e-4 t, the box
kept strict (the smallest t if none passes).
"""

from __future__ import annotations

import numpy as np
import torch

F64 = torch.float64
LS_STEPS = 16


def var_fit(series: torch.Tensor, order: int, ridge: float) -> list:
    """[A_1, ..., A_p] of x[k] = sum_j A_j x[k-j] + w by least squares
    over the series (T, nx), ridge lambda = ridge * mean(diag(AA'AA))."""
    T, nx = series.shape
    AA = torch.cat([series[order - j:T - j] for j in range(1, order + 1)],
                   dim=1)
    gram = AA.T @ AA
    gram = gram + ridge * torch.diagonal(gram).mean() * torch.eye(
        gram.shape[0], dtype=F64, device=series.device)
    para = torch.linalg.solve(gram, AA.T @ series[order:])
    return [para[j * nx:(j + 1) * nx].T for j in range(order)]


def var_stabilise(A: list, max_radius: float | None) -> list:
    """Shrink lag j by gamma^j so the companion spectral radius is at
    most ``max_radius`` (None: the fit as it is)."""
    if max_radius is None:
        return A
    p, nx = len(A), A[0].shape[0]
    comp = np.zeros((p * nx, p * nx))
    for j in range(p):
        comp[:nx, j * nx:(j + 1) * nx] = A[j].cpu().numpy()
    if p > 1:
        comp[nx:, :-nx] = np.eye((p - 1) * nx)
    rho = float(np.abs(np.linalg.eigvals(comp)).max())
    if rho <= max_radius:
        return A
    g = max_radius / rho
    return [Aj * g ** (j + 1) for j, Aj in enumerate(A)]


class FastMPC:
    """The dense KKT form of one configuration's fastMPC problem."""

    def __init__(self, A1, A2, B, mpc: dict):
        nx, nu = B.shape
        N = mpc["horizon"]
        self.nx, self.nu, self.N = nx, nu, N
        self.A1, self.A2, self.B = A1, A2, B
        self.k = mpc["barrier_k"]
        self.u_max = mpc["u_max"]
        dev = B.device
        s = nu + nx
        Z = N * s
        self.Z = Z
        self.iu = torch.cat([torch.arange(t * s, t * s + nu, device=dev)
                             for t in range(N)])               # u entries
        self.H = torch.zeros((Z, Z), dtype=F64, device=dev)
        for t in range(N):
            o = t * s
            self.H[o:o + nu, o:o + nu] = mpc["r_weight"] * torch.eye(
                nu, dtype=F64, device=dev)
            q = mpc["q_weight"] * (mpc["p_weight_scale"] if t == N - 1
                                   else 1.0)
            self.H[o + nu:o + s, o + nu:o + s] = q * torch.eye(
                nx, dtype=F64, device=dev)
        C = torch.zeros((N * nx, Z), dtype=F64, device=dev)
        for t in range(N):
            r = slice(t * nx, (t + 1) * nx)
            C[r, t * s:t * s + nu] = -B
            C[r, t * s + nu:(t + 1) * s] = torch.eye(nx, dtype=F64,
                                                     device=dev)
            if t >= 1:
                C[r, (t - 1) * s + nu:t * s] = -A1
            if t >= 2:
                C[r, (t - 2) * s + nu:(t - 1) * s] = -A2
        self.C = C
        # KKT matrix at the midpoint start, where the barrier Hessian is
        # k (1/u_max^2 + 1/u_max^2) on every u entry
        phi = 2.0 * self.H.clone()
        phi[self.iu, self.iu] += self.k * 2.0 / self.u_max ** 2
        kkt = torch.zeros((Z + N * nx, Z + N * nx), dtype=F64, device=dev)
        kkt[:Z, :Z] = phi
        kkt[:Z, Z:] = C.T
        kkt[Z:, :Z] = C
        # the Newton direction is linear in b: keep the KKT inverse's
        # columns of the equality rows
        self.kkt_b = torch.linalg.inv(kkt)[:, Z:]      # (Z + N nx, N nx)

    def rhs(self, w, x0, x0_pre, mm=torch.matmul):
        """b (..., N nx) of the equality rows."""
        nx = self.nx
        b = w.clone()
        b[..., :nx] += mm(x0, self.A1.T) + mm(x0_pre, self.A2.T)
        if self.N > 1:
            b[..., nx:2 * nx] += mm(x0, self.A2.T)
        return b

    def residual(self, z, nu, b, mm=torch.matmul):
        """(norm of [rd; rp], strictly inside the box) per row."""
        u = z[..., self.iu]
        grad = 2.0 * mm(z, self.H.T) + mm(nu, self.C)
        grad[..., self.iu] += self.k * (1.0 / (self.u_max - u)
                                        - 1.0 / (u + self.u_max))
        rp = mm(z, self.C.T) - b
        norm = torch.sqrt((grad ** 2).sum(-1) + (rp ** 2).sum(-1))
        inside = ((u < self.u_max) & (u > -self.u_max)).all(-1)
        return norm, inside

    def solve(self, w, x0, x0_pre, mm=torch.matmul) -> torch.Tensor:
        """U (..., N nu) after one line-searched Newton step; ``mm`` is
        the matrix product of the precision computed in."""
        b = self.rhs(w, x0, x0_pre, mm)
        lead = b.shape[:-1]
        z0 = torch.zeros((*lead, self.Z), dtype=b.dtype, device=b.device)
        n0 = torch.zeros_like(b)
        base, _ = self.residual(z0, n0, b, mm)
        # at the start the dual residual is 0 and the primal one -b
        d = mm(b, self.kkt_b.T)
        dz, dnu = d[..., :self.Z], d[..., self.Z:]
        t = torch.full(lead, 0.5 ** (LS_STEPS - 1), dtype=b.dtype,
                       device=b.device)
        done = torch.zeros(lead, dtype=torch.bool, device=b.device)
        for i in range(LS_STEPS):
            ti = 0.5 ** i
            norm, inside = self.residual(z0 + ti * dz, n0 + ti * dnu, b, mm)
            ok = (norm <= (1.0 - 1e-4 * ti) * base) & inside & ~done
            t = torch.where(ok, ti, t)
            done = done | ok
        z = z0 + t[..., None] * dz
        return z[..., self.iu]


def free_response(A1, A2, N: int):
    """(M1, M2) (N nx, nx): x_{t+1} = M1_t x0 + M2_t x0_pre of the
    unforced VAR(2)."""
    m1, m2 = [A1], [A2]
    if N > 1:
        m1.append(A1 @ A1 + A2)
        m2.append(A1 @ A2)
    for i in range(2, N):
        m1.append(A1 @ m1[i - 1] + A2 @ m1[i - 2])
        m2.append(m1[i - 1] @ A2)
    return torch.cat(m1), torch.cat(m2)


def warm_start(A: list, B: torch.Tensor, x1, x2, u_max: float) -> torch.Tensor:
    """The hand-over command: argmin |B u + x_pred|^2 + lam |u|^2 for the
    VAR prediction x_pred = A1 x1 (+ A2 x2), lam = 1e-6 tr(B'B)/nu raised
    tenfold (up to 20 times) until max|u| <= u_max / 2."""
    x_pred = A[0] @ x1 + (A[1] @ x2 if len(A) > 1 else 0.0)
    gram = B.T @ B
    eye = torch.eye(gram.shape[0], dtype=F64, device=B.device)
    lam = 1e-6 * float(torch.trace(gram)) / gram.shape[0]
    for _ in range(20):
        u = torch.linalg.solve(gram + lam * eye, -B.T @ x_pred)
        if float(u.abs().max()) <= 0.5 * u_max:
            break
        lam *= 10.0
    return u
