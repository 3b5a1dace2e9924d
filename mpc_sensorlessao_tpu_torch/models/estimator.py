"""Sensorless (phase-diversity) residual-aberration estimator (port of
``mpc_sensorlessao_tpu/models/estimator.py``).

Regenerates the reference's first-order PSF model y = b_s + A_s alpha
(reference: README.md:399-411) by analytic linearization of the exact
measurement map at zero aberration, and solves the linear least-squares
estimate ad_est = (A_s' A_s)^-1 A_s' (y - b_s) (README.md:478) with a
precomputed (nx, p) operator, so the per-step estimate is one matmul.
Measurement noise is seeded white Gaussian noise with its std set by the
configured SNR relative to the zero-aberration PSF signal.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np
import torch

from ..ops import dft, psf, zernike
from ..utils.config import EstimatorConfig


@dataclass(frozen=True)
class EstimatorModel:
    """Precomputed estimator operators (float32 tensors on one device).

    A_s:      (p, nx) linearized PSF sensitivity (piston excluded).
    b_s:      (p,) zero-aberration measurement.
    solve_op: (nx, p) = (A_s' A_s)^-1 A_s' -- the full estimator matmul.
    diversity_phases: (3, R, R) zd * Z_defocus maps, zd = (-a, 0, +a).
    pupil:    (R, R).
    noise_std: 0-d noise std (from SNR dB).
    dft_op:   (w, R) complex64 partial centered DFT.
    scale:    PSF intensity scale (dx^4 * AU); crop_half: static int.
    div_cos, div_sin: cos/sin of diversity_phases, the fused kernels'
              inputs; None measures the total phases unfused (kernel B3).
    div_sym3: the diversity stack is the symmetric triple (-a, 0, +a):
              measure with kernel B1, else with B2.
    dft_dtype: "float32" or "bfloat16" DFT operands of the measurement
              kernels (EstimatorConfig.dft_dtype).
    """

    A_s: torch.Tensor
    b_s: torch.Tensor
    solve_op: torch.Tensor
    diversity_phases: torch.Tensor
    pupil: torch.Tensor
    noise_std: torch.Tensor
    dft_op: torch.Tensor
    scale: float
    crop_half: int
    div_cos: torch.Tensor | None = None
    div_sin: torch.Tensor | None = None
    div_sym3: bool = False
    dft_dtype: str = "float32"

    def __post_init__(self):
        if self.dft_dtype not in DFT_DTYPES:
            raise ValueError(f"unknown dft_dtype '{self.dft_dtype}'; one of "
                             f"{DFT_DTYPES}")

    @property
    def n_pixels(self) -> int:
        return self.A_s.shape[0]


ROUTES = ("sym3", "general", "unfused")
DFT_DTYPES = ("float32", "bfloat16")


def with_route(model: EstimatorModel, route: str) -> EstimatorModel:
    """The model measuring through one route of its switch: "sym3"
    (kernel B1, the build's default), "general" (B2, ``div_sym3`` off) or
    "unfused" (B3, no diversity cos/sin maps)."""
    if route == "sym3":
        return model
    if route == "general":
        return replace(model, div_sym3=False)
    if route == "unfused":
        return replace(model, div_cos=None, div_sin=None)
    raise ValueError(f"unknown measure route '{route}'; one of {ROUTES}")


def effective_pixel_pitch(cfg: EstimatorConfig) -> float:
    """Pupil-plane pixel pitch keeping the reference's physical extent
    (512 px at 6.5 um, README.md:371) at any resolution."""
    return cfg.pixel_pitch * 512.0 / cfg.resolution


def measure(model: EstimatorModel, phase_res: torch.Tensor,
            noise: torch.Tensor | None = None) -> torch.Tensor:
    """Residual phase(s) (..., R, R) -> measurement(s) (..., p)
    (the reference estimator loop, README.md:461-475)."""
    y = psf.diversity_measurements(
        phase_res, model.diversity_phases, model.pupil, model.scale,
        model.crop_half, dft_op=model.dft_op, div_cos=model.div_cos,
        div_sin=model.div_sin, div_sym3=model.div_sym3,
        compute_dtype=("bfloat16" if model.dft_dtype == "bfloat16"
                       else None))
    if noise is not None:
        y = y + noise
    return y


def estimate(model: EstimatorModel, y: torch.Tensor) -> torch.Tensor:
    """LS estimate ad_est = solve_op @ (y - b_s)  (README.md:478)."""
    return (y - model.b_s) @ model.solve_op.T


def estimate_gauss_newton(model: EstimatorModel, y: torch.Tensor,
                          mode_stack: torch.Tensor,
                          n_iters: int) -> torch.Tensor:
    """Fixed-Jacobian Gauss-Newton refinement x <- x + S (y - f(x)) of the
    linear estimate, with f the exact PSF map and S the zero-point solve;
    ``n_iters=0`` is the reference's linear estimator.
    mode_stack: (nx, R, R) state Zernike modes."""
    x = estimate(model, y)
    nx, R = mode_stack.shape[0], mode_stack.shape[-1]
    flat = mode_stack.reshape(nx, R * R)
    for _ in range(n_iters):
        phase = (x @ flat).reshape(*x.shape[:-1], R, R)
        x = x + (y - measure(model, phase)) @ model.solve_op.T
    return x


def sample_noise(model: EstimatorModel, generator: torch.Generator,
                 shape=()) -> torch.Tensor:
    """Seeded measurement noise (..., p); ``generator`` lives on the
    model's device."""
    return model.noise_std * torch.randn(
        (*shape, model.n_pixels), generator=generator,
        dtype=model.b_s.dtype, device=model.b_s.device)


def _linearize(mode_stack, diversity_phases, pupil, dft_op, scale):
    """Analytic linearization of y = |DFT(pupil e^{i(zd Z4 + phi)})|^2 at
    phi=0:  b_s = |F0|^2 s,  A_s[:, k] = 2 Re(F0* G_k) s with
    G_k = DFT(i pupil e^{i zd Z4} Z_k).  All complex128; 8 modes at a time
    bound the (k, 3, R, R) working set."""
    mode_chunk = 8
    field0 = pupil * torch.exp(1j * diversity_phases)          # (3, R, R)
    F0 = dft.partial_centered_fft2(field0, dft_op)             # (3, w, w)
    b = psf.measurement_vector((F0.real ** 2 + F0.imag ** 2) * scale)
    cols = []
    for k0 in range(0, mode_stack.shape[0], mode_chunk):
        modes = mode_stack[k0:k0 + mode_chunk]                 # (k, R, R)
        G = dft.partial_centered_fft2(
            field0[None] * (1j * modes)[:, None], dft_op)      # (k, 3, w, w)
        dy = 2.0 * (F0.real * G.real + F0.imag * G.imag) * scale
        cols.append(psf.measurement_vector(dy))
    return b, torch.cat(cols).T                                # (p,), (p, nx)


def build(cfg: EstimatorConfig, basis: zernike.ZernikeBasis,
          device: torch.device | str = "cuda") -> EstimatorModel:
    """Build the estimator by linearizing the exact PSF map.

    The piston column is dropped, matching the reference's
    `A_s(:,1) = []` (README.md:290,331).  The linearization
    runs in complex128 on ``device``; noise_std and the solve operator are
    float64 on the host; the model is float32 on ``device``.
    """
    if cfg.method == "mmse":
        raise NotImplementedError(
            "estimator.method='mmse' is not ported yet (ROADMAP.md A.7)")
    if cfg.method != "ls":
        raise ValueError(f"unknown estimator method '{cfg.method}'")
    R = cfg.resolution
    if basis.resolution != R:
        raise ValueError("basis and estimator grids must match")
    dx = effective_pixel_pitch(cfg)
    scale = float(dx ** 4 * cfg.au)
    f64 = dict(dtype=torch.float64, device=device)

    pupil = psf.pupil_mask(R, **f64)
    defocus = basis.stack[cfg.diversity_mode].to(**f64)
    zd = torch.tensor([-cfg.diversity_amp, 0.0, cfg.diversity_amp], **f64)
    # the diversity maps are float32 in both packages: round them first
    diversity_phases = (zd[:, None, None] * defocus).float()
    dft_op = dft.centered_partial_dft(R, cfg.crop_half, device=device)

    b_s, A_s = _linearize(basis.stack[1:].to(**f64),
                          diversity_phases.double(), pupil,
                          dft_op.to(torch.complex128), scale)
    A64 = A_s.cpu().numpy()
    b64 = b_s.cpu().numpy()

    # noise scale (regenerates the missing SNR_10.mat; see EstimatorConfig)
    if cfg.snr_reference == "mean_abs":
        noise_std = float(np.mean(np.abs(b64)) * 10.0 ** (-cfg.snr_db / 20.0))
    elif cfg.snr_reference == "vector_power":
        noise_std = float(np.sqrt(np.mean(b64 ** 2)
                                  * 10.0 ** (-cfg.snr_db / 10.0)))
    else:
        raise ValueError(f"unknown snr_reference '{cfg.snr_reference}'")

    # (A'A + lam I)^-1 A'  (README.md:478), host float64 for conditioning
    gram = A64.T @ A64
    if cfg.tikhonov > 0.0:
        gram = gram + cfg.tikhonov * np.eye(gram.shape[0])
    solve_op = np.linalg.solve(gram, A64.T)                    # (nx, p)

    def f32(a):
        return torch.as_tensor(a, dtype=torch.float32, device=device)

    return EstimatorModel(
        A_s=f32(A64), b_s=f32(b64), solve_op=f32(solve_op),
        diversity_phases=diversity_phases, pupil=pupil.float(),
        noise_std=f32(noise_std), dft_op=dft_op, scale=scale,
        crop_half=cfg.crop_half,
        div_cos=torch.cos(diversity_phases.double()).float(),
        div_sin=torch.sin(diversity_phases.double()).float(),
        div_sym3=True,  # the zd stack above is always (-a, 0, +a)
        dft_dtype=cfg.dft_dtype,
    )
