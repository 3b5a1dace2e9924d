"""Independent NumPy (float64) oracle of the closed-loop MPC simulation
(the port's copy of the repository's ``tests/oracle_numpy.py``, which
oracle_reference_rows runs; numpy only, equal line for line).

Since MATLAB is unavailable, the reference loop (README.md:444-626) is
re-transcribed here in plain NumPy -- deliberately naive and structured
like the MATLAB script, sharing NO code with either engine -- to serve as
the golden-trajectory oracle (SURVEY.md section 4).
"""

from __future__ import annotations

import numpy as np


def bilinear_window(screen: np.ndarray, oy: float, ox: float,
                    size: int) -> np.ndarray:
    """Periodic bilinear sample (mirror of the JAX sampler, written
    independently with explicit index arithmetic)."""
    N = screen.shape[0]
    iy, ix = int(np.floor(oy)), int(np.floor(ox))
    fy, fx = oy - iy, ox - ix
    rows = (np.arange(size + 1) + iy) % N
    cols = (np.arange(size + 1) + ix) % N
    w = screen[np.ix_(rows, cols)]
    return ((1 - fy) * (1 - fx) * w[:size, :size]
            + (1 - fy) * fx * w[:size, 1:]
            + fy * (1 - fx) * w[1:, :size]
            + fy * fx * w[1:, 1:])


def pupil_phase(screens, step_px, step, size, mask, mag):
    total = np.zeros((size, size))
    for scr, (sy, sx) in zip(screens, step_px):
        total += bilinear_window(scr, sy * step, sx * step, size)
    inside = total[mask]
    total = (total - inside.mean()) * mask
    return total * mag


def psf_measurement(phase, pupil, div_phases, crop_half, scale):
    """fftshift/fft2 PSF stack, cropped + column-major flattened
    (README.md:461-471)."""
    R = phase.shape[0]
    c = R // 2
    ys = []
    for kW in div_phases:
        P = pupil * np.exp(1j * (phase + kW))
        I = np.abs(np.fft.fftshift(np.fft.fft2(np.fft.fftshift(P)))) ** 2
        crop = I[c - crop_half:c + crop_half + 1,
                 c - crop_half:c + crop_half + 1] * scale
        ys.append(crop.T.ravel())
    return np.concatenate(ys)


def fastmpc_dense_newton(H, g, P, h, C, b, k, z0, n_newton):
    """inf_newton_solver.m transcription (nu=0 init, full steps with
    norm-descent backtracking)."""
    z = z0.copy()
    nu = np.zeros(C.shape[0])
    for _ in range(n_newton):
        d = 1.0 / (h - P @ z)
        rd = 2 * H @ z + g + k * P.T @ d + C.T @ nu
        rp = C @ z - b
        Phi = 2 * H + k * (P.T * d ** 2) @ P
        L = np.linalg.cholesky(Phi)

        def phinv(v):
            return np.linalg.solve(L.T, np.linalg.solve(L, v))

        schur = C @ phinv(C.T)
        beta = -rp + C @ phinv(rd)
        dnu = np.linalg.solve(schur, -beta)
        dz = phinv(-rd - C.T @ dnu)
        base = np.sqrt(np.sum(rd ** 2) + np.sum(rp ** 2))
        t = 1.0
        for _bt in range(16):
            zc, nc = z + t * dz, nu + t * dnu
            if np.all(h - P @ zc > 0):
                dc = 1.0 / (h - P @ zc)
                rdc = 2 * H @ zc + g + k * P.T @ dc + C.T @ nc
                rpc = C @ zc - b
                if np.sqrt(np.sum(rdc ** 2) + np.sum(rpc ** 2)) <= \
                        (1 - 1e-4 * t) * base:
                    break
            t *= 0.5
        z, nu = z + t * dz, nu + t * dnu
    return z


def assemble_fastmpc(Q, R, Qf, A1, A2, B, w, x0, x0_pre, u_min, u_max, T):
    """fast_mpc_objective/eq/ineq transcription (box-only, VAR_2)."""
    n, m = B.shape
    Z = T * (n + m)
    H = np.zeros((Z, Z))
    for t in range(T):
        uo = t * (n + m)
        xo = uo + m
        H[uo:uo + m, uo:uo + m] = R
        H[xo:xo + n, xo:xo + n] = Qf if t == T - 1 else Q
    g = np.zeros(Z)
    C = np.zeros((T * n, Z))
    b = np.zeros(T * n)
    w = w.reshape(T, n)
    for i in range(T):
        uo = i * (n + m)
        C[i * n:(i + 1) * n, uo:uo + m] = -B
        C[i * n:(i + 1) * n, uo + m:uo + m + n] = np.eye(n)
        if i >= 1:
            xo_prev = (i - 1) * (n + m) + m
            C[i * n:(i + 1) * n, xo_prev:xo_prev + n] = -A1
        if i >= 2:
            xo_pp = (i - 2) * (n + m) + m
            C[i * n:(i + 1) * n, xo_pp:xo_pp + n] = -A2
        bi = w[i].copy()
        if i == 0:
            bi += A1 @ x0 + A2 @ x0_pre
        elif i == 1:
            bi += A2 @ x0
        b[i * n:(i + 1) * n] = bi
    Pm = np.zeros((2 * T * m, Z))
    h = np.zeros(2 * T * m)
    for t in range(T):
        uo = t * (n + m)
        Pm[2 * t * m:2 * t * m + m, uo:uo + m] = np.eye(m)
        Pm[2 * t * m + m:2 * (t + 1) * m, uo:uo + m] = -np.eye(m)
        h[2 * t * m:2 * t * m + m] = u_max
        h[2 * t * m + m:2 * (t + 1) * m] = -u_min
    z0 = np.zeros(Z)
    for t in range(T):
        z0[t * (n + m):t * (n + m) + m] = (u_min + u_max) / 2
    return H, g, Pm, h, C, b, z0


def closed_loop(params: dict, n_steps: int, noise: np.ndarray,
                solver: str = "fastmpc", cold_start: str = "hold",
                gauss_newton_iters: int = 0):
    """The reference loop (README.md:444-626) in NumPy float64.

    params: screens (L,Ns,Ns), step_px (L,2), start, mag, mask, pupil,
    div_phases (3,R,R), crop_half, scale, A_s, b_s, solve_op, influence
    (nx,m_act), state_stack (nx,R,R), M1, M2, B_conv, Q_tilda, H_cond,
    closed_form, A1, A2, Q, R, Qf (stage costs), u_max, barrier_k,
    newton_steps, horizon.
    """
    p = params
    R = p["mask"].shape[0]
    nx, m_act = p["influence"].shape
    N = p["horizon"]
    u1 = np.zeros(m_act)
    u2 = np.zeros(m_act)
    x_pre = np.zeros(nx)
    phase_cor = np.zeros((R, R))
    us, rms = [], []
    M1B = p["M1"] @ p["influence"]
    M2B = p["M2"] @ p["influence"]
    for k in range(n_steps):
        phase_turb = pupil_phase(p["screens"], p["step_px"],
                                 p["start"] + k, R, p["mask"], p["mag"])
        phase_res = phase_turb + phase_cor
        y = psf_measurement(phase_res, p["pupil"], p["div_phases"],
                            p["crop_half"], p["scale"]) + noise[k]
        x0 = p["solve_op"] @ (y - p["b_s"])
        for _ in range(gauss_newton_iters):
            ph_est = np.tensordot(x0, p["state_stack"], axes=(0, 0))
            y_pred = psf_measurement(ph_est, p["pupil"], p["div_phases"],
                                     p["crop_half"], p["scale"])
            x0 = x0 + p["solve_op"] @ (y - y_pred)
        xp = x0 if (cold_start == "hold" and k == 0) else x_pre
        b_ref = -M1B @ u1 - M2B @ u2
        x_free = p["M1"] @ x0 + p["M2"] @ xp + b_ref
        r = 2 * p["B_conv"].T @ p["Q_tilda"] @ x_free
        if solver == "closed_form":
            U = p["closed_form"] @ r
        else:
            H, g, Pm, h, C, b, z0 = assemble_fastmpc(
                p["Q"], p["R"], p["Qf"], p["A1"], p["A2"], p["influence"],
                b_ref, x0, xp, -p["u_max"] * np.ones(m_act),
                p["u_max"] * np.ones(m_act), N)
            z = fastmpc_dense_newton(H, g, Pm, h, C, b, p["barrier_k"], z0,
                                     p["newton_steps"])
            U = np.concatenate([
                z[t * (nx + m_act):t * (nx + m_act) + m_act]
                for t in range(N)])
        u = U[:m_act]
        ad_cor = p["influence"] @ u
        phase_cor = np.tensordot(ad_cor, p["state_stack"], axes=(0, 0))
        u2, u1, x_pre = u1, u, x0
        us.append(u)
        inside = phase_res[p["mask"]]
        rms.append(np.sqrt(np.mean((inside - inside.mean()) ** 2)))
    return np.stack(us), np.asarray(rms)
