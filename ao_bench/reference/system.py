"""The whole reference: build from a configuration and a seed, one batched
closed-loop step from a given loop state, and the loop itself.

``Reference(cfg, device)`` computes in float64; the screens come from
the configuration's ``sim.seed``.  With
``precision="tf32"`` it computes in float32 with every matrix product's
operands rounded to TF32 (10 explicit mantissa bits, round to nearest
even) and float32 sums, as the tensor cores' TF32 mode does: the
benchmark's control, the next precision below the float32 the
configurations state.
"""

from __future__ import annotations

import numpy as np
import torch

from . import control, optics, turbulence

F64 = torch.float64


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10-bit mantissa, to nearest even (the
    bit pattern of a finite float32 never overflows the int32 sum)."""
    i = x.float().contiguous().view(torch.int32)
    i = (i + 0xFFF + ((i >> 13) & 1)) & ~0x1FFF
    return i.view(torch.float32)


class Precision:
    """The arithmetic one reference computes in: "float64" or "tf32"."""

    def __init__(self, name: str):
        if name not in ("float64", "tf32"):
            raise ValueError(f"unknown reference precision {name!r}")
        self.name = name
        self.dtype = F64 if name == "float64" else torch.float32

    def cast(self, t: torch.Tensor) -> torch.Tensor:
        if t.is_complex():
            return t.to(torch.complex128 if self.name == "float64"
                        else torch.complex64)
        return t.to(self.dtype)

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.name == "float64":
            return a.to(F64) @ b.to(F64)
        return tf32(a) @ tf32(b)

    def cmm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """Complex product as real products of this precision."""
        if self.name == "float64":
            return a @ b
        ar, ai, br, bi = (tf32(x) for x in (a.real, a.imag, b.real, b.imag))
        return torch.complex(ar @ br - ai @ bi, ar @ bi + ai @ br)


def magnification(d_over_r0: float) -> float:
    """Turbulence scaling of D/r0 against the base D/r0 = 5:
    (d / 5)^(5/6), the Kolmogorov phase-rms law."""
    return (d_over_r0 / 5.0) ** (5.0 / 6.0)


class Reference:
    """Every operator of one configuration, worked out from its file."""

    ROLLOUT_CHUNK = 50

    def __init__(self, cfg: dict, device, precision: str = "float64"):
        self.prec = Precision(precision)
        est, mpc, sim = cfg["estimator"], cfg["mpc"], cfg["sim"]
        tel, atm = cfg["telescope"], cfg["atmosphere"]
        if est["resolution"] != tel["resolution"]:
            raise ValueError("telescope and estimator grids differ")
        if mpc["solver"] != "fastmpc" or mpc["newton_steps"] != 1:
            raise ValueError("the reference holds the one-step fastMPC")
        if (mpc["est_gain"] != 1.0 or mpc["innovation_gate"] is not None
                or est["track_gn_iters"] or mpc["var_order"] > 2):
            raise ValueError("estimator fusion, tracking and VAR orders "
                             "above 2 are not in the reference")
        self.device = device
        self.op = optics.Optics(cfg, device)
        R = self.R = est["resolution"]
        self.screens = turbulence.Screens(
            sim["seed"], atm, R, tel["diameter"], tel["sampling_freq"], device)
        self.b_s, A_s = self.op.linearise()
        self.sigma = optics.noise_std(self.b_s, est)
        mag = magnification(sim["d_over_r0"])
        if est["method"] == "ls":
            self.gain = optics.ls_gain(A_s, est["tikhonov"])
        elif est["method"] == "mmse":
            C = optics.zernike_prior(atm, tel["diameter"],
                                     cfg["zernike"]["radial_order"])
            prior = torch.as_tensor(C[1:, 1:] * mag ** 2
                                    * est["prior_scale"] ** 2, device=device)
            self.gain = optics.mmse_gain(A_s, prior, self.sigma)
        else:
            raise ValueError(f"unknown estimator {est['method']!r}")
        self.gn = est["gauss_newton_iters"]
        self.influence = optics.dm_influence(cfg["dm"], R, self.op.maps,
                                             self.op.mask)      # (nx, nu)
        start = sim["n_train"] + sim["n_valid"]
        series = self.rollout(np.arange(sim["n_train"]), mag)
        A = control.var_stabilise(
            control.var_fit(series[:, 1:], mpc["var_order"],
                            mpc["var_ridge"]), mpc["var_max_radius"])
        A1 = A[0]
        A2 = A[1] if len(A) > 1 else torch.zeros_like(A1)
        M1, M2 = control.free_response(A1, A2, mpc["horizon"])
        self.M1B, self.M2B = M1 @ self.influence, M2 @ self.influence
        self.mpc = control.FastMPC(A1, A2, self.influence, mpc)
        self.nu = self.influence.shape[1]
        self.init_u = None
        if mpc["warm_start"]:
            last = self.rollout(np.array([start - 1, start - 2]), mag)
            self.init_u = control.warm_start(A, self.influence,
                                             last[0, 1:], last[1, 1:],
                                             mpc["u_max"])
        self.hold = mpc["cold_start"] == "hold"
        w2 = self.op.w ** 2
        self.peak_dl = float(self.b_s[w2:2 * w2].max())

    # -- pieces ---------------------------------------------------------
    def rollout(self, steps, mag: float) -> torch.Tensor:
        """(len(steps), K) Zernike coefficients of the magnified,
        piston-removed open-loop phase at the given steps."""
        p = self.prec
        out = []
        for i in range(0, len(steps), self.ROLLOUT_CHUNK):
            pt = self.piston_removed(self.screens.phase(
                steps[i:i + self.ROLLOUT_CHUNK])) * mag
            out.append(p.mm(pt.reshape(pt.shape[0], -1), self.op.fit.T))
        return torch.cat(out).to(F64)

    def piston_removed(self, raw: torch.Tensor) -> torch.Tensor:
        """Phase minus its mean over the Zernike disc, zero outside."""
        m = self.prec.cast(self.op.mask.to(F64))
        raw = self.prec.cast(raw)
        mean = (raw * m).sum((-2, -1), keepdim=True) / self.op.npix
        return (raw - mean) * m

    def disc_rms(self, phase: torch.Tensor) -> torch.Tensor:
        """RMS about the mean over the Zernike disc."""
        m = self.prec.cast(self.op.mask.to(F64))
        mean = (phase * m).sum((-2, -1), keepdim=True) / self.op.npix
        return torch.sqrt((((phase - mean) * m) ** 2).sum((-2, -1))
                          / self.op.npix)

    def measure(self, phase: torch.Tensor) -> torch.Tensor:
        """Noiseless measurements (P, 3 w^2) of phases (P, R, R)."""
        p = self.prec
        chunk = 32 if p.name == "float64" else 128
        A = p.cast(self.op.A)
        pupil, div = p.cast(self.op.pupil), p.cast(self.op.div)
        out = []
        for i in range(0, phase.shape[0], chunk):
            f = pupil * torch.exp(1j * (phase[i:i + chunk, None] + div))
            G = p.cmm(p.cmm(A, f), A.T)
            out.append(optics.stack_column_major(
                (G.real ** 2 + G.imag ** 2) * self.op.scale))
        return torch.cat(out)

    def synth(self, coeffs: torch.Tensor) -> torch.Tensor:
        """(P, R, R) phase of state coefficients (P, nx)."""
        flat = self.op.states.reshape(self.op.states.shape[0], -1)
        return self.prec.mm(coeffs, flat).reshape(-1, self.R, self.R)

    # -- the loop -------------------------------------------------------
    def step(self, steps, mag, scale, u1, u2, x_pre, first, z) -> dict:
        """One closed-loop step of P (scenario, step) pairs from the loop
        state the pairs hand in.

        steps (P,) float32 window steps; mag, scale (P,) magnification
        and noise multiplier; u1, u2 (P, nu) the last two commands (the
        warm start, or 0, before the first); x_pre (P, nx) the last
        estimate (0 before the first); first (P,) bool: the loop's first
        step; z (P, p) the step's standard normal noise draws.  Returns
        x_est, u, rms_res, rms_turb and strehl_exact per pair."""
        p, mm = self.prec, self.prec.mm
        mag = p.cast(torch.as_tensor(mag, device=self.device))
        scale = p.cast(torch.as_tensor(scale, device=self.device))
        steps = np.asarray(steps, dtype=np.float32)
        uniq, inv = np.unique(steps, return_inverse=True)
        pt_u = torch.cat([self.piston_removed(self.screens.phase(
            uniq[i:i + 64])) for i in range(0, len(uniq), 64)])
        pt = pt_u[torch.as_tensor(inv, device=self.device)] * mag[:, None,
                                                                  None]
        u1, u2, x_pre = p.cast(u1), p.cast(u2), p.cast(x_pre)
        phase = self.synth(mm(u1, self.influence.T)) + pt
        y_clean = self.measure(phase)
        y = y_clean + self.sigma * scale[:, None] * p.cast(z)
        b_s = p.cast(self.b_s)
        x0 = mm(y - b_s, self.gain.T)
        for _ in range(self.gn):
            x0 = x0 + mm(y - self.measure(self.synth(x0)), self.gain.T)
        hold = torch.as_tensor(np.asarray(first), device=self.device)
        if self.hold:
            x_pre = torch.where(hold[:, None], x0, x_pre)
        w = -mm(u1, self.M1B.T) - mm(u2, self.M2B.T)
        u = self.mpc.solve(w, x0, x_pre, mm)[:, :self.nu]
        w2 = self.op.w ** 2
        return {"x_est": x0, "u": u, "rms_res": self.disc_rms(phase),
                "rms_turb": self.disc_rms(pt),
                "strehl_exact": y_clean[:, w2:2 * w2].amax(-1) / self.peak_dl}

    def loop(self, starts, mag, scale, n_steps: int, noise, chunk: int = 256
             ) -> dict:
        """The closed loop of B scenarios for n_steps from their window
        starts (B,) float32, each step's normals from ``noise(t)`` (B,
        p); outputs (B, T, ...) of the step's fields."""
        B = len(starts)
        p = self.prec
        zeros = torch.zeros((B, self.nu), dtype=p.dtype, device=self.device)
        u1 = (zeros if self.init_u is None
              else p.cast(self.init_u).expand(B, -1).clone())
        u2 = zeros
        x_pre = torch.zeros((B, self.influence.shape[0]), dtype=p.dtype,
                            device=self.device)
        steps_out = []
        starts = np.asarray(starts, dtype=np.float32)
        mag = torch.as_tensor(mag, device=self.device)
        scale = torch.as_tensor(scale, device=self.device)
        for t in range(n_steps):
            z = noise(t)
            parts = [self.step(starts[i:i + chunk] + np.float32(t),
                               mag[i:i + chunk], scale[i:i + chunk],
                               u1[i:i + chunk], u2[i:i + chunk],
                               x_pre[i:i + chunk],
                               np.full(min(chunk, B - i), t == 0),
                               z[i:i + chunk])
                     for i in range(0, B, chunk)]
            out = {k: torch.cat([q[k] for q in parts]) for k in parts[0]}
            steps_out.append(out)
            u1, u2, x_pre = out["u"], u1, out["x_est"]
        return {k: torch.stack([s[k] for s in steps_out], dim=1)
                for k in steps_out[0]}
