"""Sensorless (phase-diversity) residual-aberration estimator (port of
``mpc_sensorlessao_tpu/models/estimator.py``).

Regenerates the reference's first-order PSF model y = b_s + A_s alpha
(reference: README.md:399-411) by analytic linearization of the exact
measurement map at zero aberration, and solves the linear least-squares
estimate ad_est = (A_s' A_s)^-1 A_s' (y - b_s) (README.md:478) -- or,
with ``method="mmse"``, the Bayesian linear MMSE estimate under a
turbulence prior -- with a precomputed (nx, p) operator, so the per-step
estimate is one matmul.  ``estimate_full_gn`` refines it by Gauss-Newton
on the exact map re-linearized at each iterate (``linearize_at``).
Measurement noise is seeded white Gaussian noise with its std set by the
configured SNR relative to the zero-aberration PSF signal.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np
import torch

from ..ops import dft, psf, zernike
from ..utils import profiling
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
    map_reg:  (nx, nx) MAP regularizer sigma^2 C_prior^-1 of the mmse
              estimator, else None; estimate_full_gn then solves the MAP
              normal equations, keeping the linear estimate's high-order
              shrinkage through the refinement.
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
    map_reg: torch.Tensor | None = None

    def __post_init__(self):
        if self.dft_dtype not in DFT_DTYPES:
            raise ValueError(f"unknown dft_dtype '{self.dft_dtype}'; one of "
                             f"{DFT_DTYPES}")

    @property
    def n_pixels(self) -> int:
        return self.A_s.shape[0]

    @property
    def n_states(self) -> int:
        return self.A_s.shape[1]


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
        with profiling.span("measure"):
            y_x = measure(model, phase)
        x = x + (y - y_x) @ model.solve_op.T
    return x


def sample_noise(model: EstimatorModel, generator: torch.Generator,
                 shape=()) -> torch.Tensor:
    """Seeded measurement noise (..., p); ``generator`` lives on the
    model's device."""
    return model.noise_std * torch.randn(
        (*shape, model.n_pixels), generator=generator,
        dtype=model.b_s.dtype, device=model.b_s.device)


# linearize_at's working set: (scenarios, modes, n_div, R, R) complex
# fields, MODE_CHUNK modes at a time (the JAX mode_chunk) and as many
# scenarios as fit in LINEARIZE_BYTES
MODE_CHUNK = 8
LINEARIZE_BYTES = 1 << 30


def _linearize_fields(field, mode_stack, dft_op, scale):
    """Analytic linearization of y = |DFT(field e^{i phi})|^2 at phi=0
    for fields (S, n_div, R, R): y0 = |F|^2 s and J[:, k] = 2 Re(F* G_k) s
    with G_k = DFT(i field Z_k), F = DFT(field).  Returns y0 (S, p) and
    J (S, p, nx) in the fields' precision."""
    F = dft.partial_centered_fft2(field, dft_op)               # (S, d, w, w)
    y0 = psf.measurement_vector((F.real ** 2 + F.imag ** 2) * scale)
    S, n_div, R = field.shape[0], field.shape[1], field.shape[-1]
    nx = mode_stack.shape[0]
    k = min(MODE_CHUNK, nx)
    s_chunk = max(1, LINEARIZE_BYTES
                  // (k * n_div * R * R * field.element_size()))
    imodes = (1j * mode_stack)[:, None]                        # (nx, 1, R, R)
    J = torch.empty((S, nx, y0.shape[-1]), dtype=y0.dtype,
                    device=y0.device)
    for s0 in range(0, S, s_chunk):
        f = field[s0:s0 + s_chunk, None]                       # (s, 1, d, R, R)
        Fs = F[s0:s0 + s_chunk, None]
        for k0 in range(0, nx, k):
            G = dft.partial_centered_fft2(f * imodes[k0:k0 + k], dft_op)
            dy = 2.0 * (Fs.real * G.real + Fs.imag * G.imag) * scale
            J[s0:s0 + s_chunk, k0:k0 + k] = psf.measurement_vector(dy)
    return y0, J.transpose(-1, -2)


def linearize_at(model: EstimatorModel, phase: torch.Tensor,
                 mode_stack: torch.Tensor):
    """Exact re-linearization of the measurement map at ``phase``
    (..., R, R): y0 = f(phase) (..., p) and J (..., p, nx), J[:, k] =
    df/dx_k, the analytic form of build()'s zero-point linearization in
    complex64, chunked over scenarios and modes (LINEARIZE_BYTES)."""
    batch, R = phase.shape[:-2], phase.shape[-1]
    field = model.pupil * torch.exp(
        1j * (model.diversity_phases + phase.reshape(-1, 1, R, R)))
    y0, J = _linearize_fields(field, mode_stack, model.dft_op, model.scale)
    return y0.reshape(*batch, -1), J.reshape(*batch, *J.shape[1:])


def estimate_full_gn(model: EstimatorModel, y: torch.Tensor,
                     mode_stack: torch.Tensor, n_iters: int,
                     damping: float = 1e-3,
                     x_init: torch.Tensor | None = None) -> torch.Tensor:
    """Full Gauss-Newton with the Jacobian re-linearized at each iterate,
    batched over the leading dims of ``y`` (..., p).

    Each iteration solves (J'J + reg) dx = J'(y - f(x)) - map_reg (x -
    x_mean), reg = damping tr(A_s'A_s)/nx I (+ map_reg for the mmse
    estimator), by a batched Cholesky factor.  ``x_init`` seeds the
    iteration (default: the linear cold estimate) and is the prior mean
    of the MAP term (zero for a cold solve): a tracking solve penalizes
    the distance from its prediction, not the aberration's size.  A
    scenario whose matrix is not positive definite gets NaN, as the JAX
    package's Cholesky solve gives it, and the other scenarios their
    solution.
    """
    cold = x_init is None
    x = estimate(model, y) if cold else x_init
    nx = model.n_states
    lam = damping * torch.trace(model.A_s.T @ model.A_s) / nx
    reg = lam * torch.eye(nx, dtype=model.A_s.dtype, device=model.A_s.device)
    if model.map_reg is not None:
        reg = model.map_reg + reg
    R = mode_stack.shape[-1]
    flat = mode_stack.reshape(nx, R * R)
    for _ in range(n_iters):
        phase = (x @ flat).reshape(*x.shape[:-1], R, R)
        y0, J = linearize_at(model, phase, mode_stack)
        Jt = J.transpose(-1, -2)
        g = (Jt @ (y - y0)[..., None])[..., 0]
        if model.map_reg is not None:
            g = g - (x if cold else x - x_init) @ model.map_reg.T
        L, info = torch.linalg.cholesky_ex(Jt @ J + reg)
        dx = torch.cholesky_solve(g[..., None], L)[..., 0]
        x = x + torch.where((info != 0)[..., None], torch.nan, dx)
    return x


def build(cfg: EstimatorConfig, basis: zernike.ZernikeBasis,
          prior_cov: np.ndarray | None = None,
          device: torch.device | str = "cuda") -> EstimatorModel:
    """Build the estimator by linearizing the exact PSF map.

    The piston column is dropped, matching the reference's
    `A_s(:,1) = []` (README.md:290,331).  The linearization
    runs in complex128 on ``device``; noise_std, the solve operator and
    map_reg are float64 on the host; the model is float32 on ``device``.

    ``prior_cov`` ((nx, nx), rad^2) is required when cfg.method == "mmse":
    the solve operator becomes the Bayesian linear MMSE gain
    C A' (A C A' + sigma^2 I)^-1 instead of the reference's unweighted
    normal equations (see EstimatorConfig.method).
    """
    if cfg.method not in ("ls", "mmse"):
        raise ValueError(f"unknown estimator method '{cfg.method}'")
    if cfg.method == "mmse" and prior_cov is None:
        raise ValueError("estimator method 'mmse' needs prior_cov "
                         "(see pipeline.build)")
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

    field0 = pupil * torch.exp(1j * diversity_phases.double())
    b_s, A_s = _linearize_fields(field0[None], basis.stack[1:].to(**f64),
                                 dft_op.to(torch.complex128), scale)
    A64 = A_s[0].cpu().numpy()
    b64 = b_s[0].cpu().numpy()

    # noise scale (regenerates the missing SNR_10.mat; see EstimatorConfig)
    if cfg.snr_reference == "mean_abs":
        noise_std = float(np.mean(np.abs(b64)) * 10.0 ** (-cfg.snr_db / 20.0))
    elif cfg.snr_reference == "vector_power":
        noise_std = float(np.sqrt(np.mean(b64 ** 2)
                                  * 10.0 ** (-cfg.snr_db / 10.0)))
    else:
        raise ValueError(f"unknown snr_reference '{cfg.snr_reference}'")

    # solve operator, host float64 for conditioning
    map_reg = None
    if cfg.method == "ls":
        # (A'A + lam I)^-1 A'  (README.md:478)
        gram = A64.T @ A64
        if cfg.tikhonov > 0.0:
            gram = gram + cfg.tikhonov * np.eye(gram.shape[0])
        solve_op = np.linalg.solve(gram, A64.T)                # (nx, p)
    else:
        C = np.asarray(prior_cov, dtype=np.float64)
        if C.shape != (A64.shape[1],) * 2:
            raise ValueError(f"prior_cov shape {C.shape} != "
                             f"({A64.shape[1]}, {A64.shape[1]})")
        CA = C @ A64.T                                         # (nx, p)
        G = A64 @ CA
        # the sigma^2 floor keeps G invertible at (near-)noiseless SNR:
        # A C A' has rank <= nx << p
        sig2 = max(noise_std ** 2, 1e-9 * float(np.trace(G)) / G.shape[0])
        G = G + sig2 * np.eye(A64.shape[0])
        solve_op = np.linalg.solve(G, CA.T).T                  # (nx, p)
        map_reg = sig2 * np.linalg.inv(
            C + 1e-12 * float(np.trace(C)) / C.shape[0] * np.eye(C.shape[0]))

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
        map_reg=None if map_reg is None else f32(map_reg),
    )
