"""Von Karman phase-screen synthesis and frozen-flow evolution
(port of ``mpc_sensorlessao_tpu/ops/phase_screens.py``).

* each layer gets ONE oversampled periodic FFT screen with subharmonic
  low-frequency compensation (reference: atmosphere.m:449-474,518-591),
  synthesized on the host in numpy float64 from an integer seed -- the
  same code and seeds as the JAX package, so the screens are identical;
* frozen flow is *sampling*: the pupil window slides across the periodic
  screen along the wind vector (an integer window offset plus a 4-tap
  bilinear blend) on the device;
* the on-axis NGS phase is the plain sum over layers
  (telescopeAbstract.m:446-447), piston-removed downstream;
* at a (B,) tensor of per-scenario steps, ``piston_removed_phase_at``
  samples, sums and piston-removes each scenario's windows in one pass:
  kernel T1 (csrc/phase_window.cu) on a CUDA tensor.
"""

from __future__ import annotations

import ctypes
import math
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field

import numpy as np
import torch

from ..utils.config import AtmosphereConfig, TelescopeConfig
from . import cuda_build, phase_stats, zernike

# host threads and rows a band for the subharmonic patches
SCREEN_THREADS = 8
SUBHARMONIC_ROWS = 32


@dataclass(frozen=True)
class FrozenFlowLayers:
    """Per-layer periodic screens + wind stepping.

    screens: (L, Ns, Ns) float32 phase screens [rad], wrap-padded by R+1.
    step_px: (L, 2) float32 wind displacement per step in (row, col) px.
    step_px_host: a host copy of step_px, so a shared-window step computes
    its window offsets without a device round trip.
    """

    screens: torch.Tensor
    step_px: torch.Tensor
    step_px_host: np.ndarray = field(init=False, repr=False, compare=False)

    def __post_init__(self):
        object.__setattr__(self, "step_px_host",
                           self.step_px.detach().cpu().numpy()
                           .astype(np.float32))

    @property
    def n_layers(self) -> int:
        return self.screens.shape[0]


def synthesize_screen(seed: int, atm: AtmosphereConfig, n_pixels: int,
                      pitch: float, oversample: int | None = None,
                      subharmonic_levels: int | None = None,
                      method: str = "fourier") -> np.ndarray:
    """One Von Karman screen, (os*n_pixels)^2, float32.

    Methods (the reference's synthesis family):
      "fourier":  fourierPhaseScreen (atmosphere.m:449-474), periodic:
                  map = real(ifft2(psdRoot .* fft2(randn(N))/N)) * N^2 * df,
                  plus subharmonic patches below the fundamental frequency;
      "straight": fourierPhaseScreenStraight (atmosphere.m:476-516):
                  complex spectral draws, DC zeroed, no oversampling gain;
      "cholesky": choleskyPhaseScreen (atmosphere.m:593-641): exact dense
                  covariance factorization -- small grids only
                  (O(N^4) memory), no periodicity.
    os defaults to atm.oversample, the subharmonic levels to
    atm.subharmonic_levels.  ``atm`` should be a single-layer slab
    (atm.layer(i)) so the fractional r0 weighting is per layer.
    """
    if oversample is None:
        oversample = atm.oversample
    if subharmonic_levels is None:
        subharmonic_levels = atm.subharmonic_levels
    N = oversample * n_pixels
    if method == "cholesky":
        return _cholesky_screen(seed, atm, N, pitch)
    if method == "straight":
        return _straight_screen(seed, atm, N, pitch)
    if method != "fourier":
        raise ValueError(f"unknown screen method '{method}'")
    df = 1.0 / (N * pitch)

    fx = np.fft.fftfreq(N, d=pitch)
    fr = np.sqrt(fx[:, None] ** 2 + fx[None, :] ** 2)
    psd_root = np.sqrt(phase_stats.spectrum(fr, atm, np))
    # zero DC: the subharmonics (or piston removal) cover it
    psd_root[0, 0] = 0.0

    rng = _host_rng(seed)
    w = rng.standard_normal((N, N))
    c = np.fft.fft2(w) / N
    screen = np.real(np.fft.ifft2(psd_root * c)) * (N * N) * df
    if subharmonic_levels > 0:
        screen = screen + _subharmonics(rng, atm, N, pitch, df,
                                        subharmonic_levels)
    return np.asarray(screen, dtype=np.float32)


def _straight_screen(seed: int, atm: AtmosphereConfig, N: int,
                     pitch: float) -> np.ndarray:
    """fourierPhaseScreenStraight (atmosphere.m:476-516): independent
    complex spectral draws cn = (randn + i randn) sqrt(PSD) df, DC zeroed,
    out = real(ifftshift(ifft2(ifftshift(cn)))) N^2."""
    rng = _host_rng(seed)
    del_f = 1.0 / (N * pitch)
    fx = (np.arange(N) - N // 2) * del_f
    f = np.hypot(fx[:, None], fx[None, :])
    psd = phase_stats.spectrum(f, atm, np)
    psd[N // 2, N // 2] = 0.0
    cn = ((rng.standard_normal((N, N)) + 1j * rng.standard_normal((N, N)))
          * np.sqrt(psd) * del_f)
    out = np.real(np.fft.ifftshift(np.fft.ifft2(np.fft.ifftshift(cn)))) * N * N
    return np.asarray(out, dtype=np.float32)


def _cholesky_screen(seed: int, atm: AtmosphereConfig, N: int,
                     pitch: float) -> np.ndarray:
    """choleskyPhaseScreen (atmosphere.m:593-641): exact sampling via a
    dense covariance Cholesky factor; O(N^4) -- small N only."""
    if N > 96:
        raise ValueError("cholesky screens are O(N^4); use N<=96")
    rng = _host_rng(seed)
    ax = np.arange(N) * pitch
    pts = (ax[:, None] + 1j * ax[None, :]).ravel()
    C = phase_stats.covariance_matrix(pts, pts, atm)
    L = np.linalg.cholesky(C + 1e-9 * np.eye(N * N))
    return np.asarray((L @ rng.standard_normal(N * N)).reshape(N, N),
                      dtype=np.float32)


def _host_rng(seed: int) -> np.random.Generator:
    """Deterministic host RNG from an integer seed (the JAX package's
    int-seed branch, so both packages draw the same screens)."""
    if not isinstance(seed, (int, np.integer)):
        raise TypeError(f"screen seeds are integers, got {type(seed)}")
    return np.random.default_rng(np.random.SeedSequence([int(seed)]))


def _subharmonics(rng: np.random.Generator, atm: AtmosphereConfig, N: int,
                  pitch: float, df: float, levels: int) -> np.ndarray:
    """Low-frequency compensation patches (Lane et al. 1992; the
    reference's fourierSubHarmonicPhaseScreen, atmosphere.m:518-591).

    For each level l, a 3x3 grid of frequencies at spacing df/3^l replaces
    the coarser cell it subdivides; the central cell is left to the next
    level, and DC is skipped.

    The draws are made first, in the JAX package's order; the patches are
    then summed in bands of SUBHARMONIC_ROWS rows in host threads (numpy
    releases the interpreter lock in its array math).  Each pixel sees the
    same float64 operations in the same order as in one pass over the
    whole grid, so the screen is bit for bit the JAX package's.
    """
    x = np.arange(N) * pitch
    XX = x[:, None, None].transpose(2, 0, 1)   # (1, N, 1)
    YY = x[None, None, :]                      # (1, 1, N)
    draws = []
    for lvl in range(1, levels + 1):
        df_l = df / (3.0 ** lvl)
        f = np.asarray([(p * df_l, q * df_l)
                        for p in (-1, 0, 1) for q in (-1, 0, 1)
                        if not (p == 0 and q == 0)])            # (8, 2)
        amp = np.sqrt(
            phase_stats.spectrum(np.hypot(f[:, 0], f[:, 1]), atm, np)
        ) * df_l
        a = rng.standard_normal(f.shape[0]) * amp
        b = rng.standard_normal(f.shape[0]) * amp
        draws.append((f, a, b))
    total = np.zeros((N, N))

    def band(r0):
        rows = slice(r0, min(r0 + SUBHARMONIC_ROWS, N))
        acc = total[rows]
        for f, a, b in draws:
            phase_arg = 2.0 * math.pi * (XX[:, rows] * f[:, 0:1, None]
                                         + YY * f[:, 1:2, None])
            acc = acc + np.sum(
                a[:, None, None] * np.cos(phase_arg)
                + b[:, None, None] * np.sin(phase_arg), axis=0)
        total[rows] = acc
    with ThreadPoolExecutor(SCREEN_THREADS) as pool:
        list(pool.map(band, range(0, N, SUBHARMONIC_ROWS)))
    return total


def make_layers(seed: int, atm: AtmosphereConfig, tel: TelescopeConfig,
                cover_steps: int | None = None, max_screen: int = 4096,
                device: torch.device | str = "cuda") -> FrozenFlowLayers:
    """Build all layer screens + per-step pixel shifts.

    Wind shift per step: v * dt / pitch pixels along (sin, cos) of the
    wind direction, in (row, col).

    ``cover_steps``: size the screens so a rollout of that many steps never
    revisits screen area (the role of the reference's conditional-Gaussian
    edge extension, telescopeAbstract.m:335-342, without its finite
    conditioning window).  None -> the default periodic oversampled screen
    (wrap after ~os*R/|d| steps).  Capped at ``max_screen`` px per side.
    """
    R = tel.resolution
    pitch = tel.pixel_pitch
    seeds = [int(seed) * 1000003 + i for i in range(atm.n_layers)]
    steps = []
    for i in range(atm.n_layers):
        dpx = atm.wind_speeds[i] * tel.sampling_time / pitch
        th = atm.wind_directions[i]
        steps.append((dpx * math.sin(th), dpx * math.cos(th)))

    oversample = atm.oversample
    if cover_steps is not None:
        max_d = max(max(abs(sy), abs(sx)) for sy, sx in steps)
        need = R + 2 + int(math.ceil(cover_steps * max_d))
        need = min(need, max_screen)
        oversample = max(oversample, int(math.ceil(need / R)))

    def screen(i):
        scr = synthesize_screen(seeds[i], atm.layer(i), R, pitch,
                                oversample=oversample)
        # wrap-pad by the window size so every window is one plain slice
        return np.pad(scr, ((0, R + 1), (0, R + 1)), mode="wrap")
    # one host thread a layer: each screen is the same function of its seed
    with ThreadPoolExecutor(atm.n_layers) as pool:
        screens = list(pool.map(screen, range(atm.n_layers)))
    return FrozenFlowLayers(
        screens=torch.as_tensor(np.stack(screens), dtype=torch.float32,
                                device=device),
        step_px=torch.as_tensor(np.asarray(steps), dtype=torch.float32,
                                device=device),
    )


def _weights(fy, fx):
    """Bilinear tap weights, formed in float32 from float32 fractions
    (numpy float32 scalars or tensors) in the JAX package's order."""
    return ((1 - fy) * (1 - fx), (1 - fy) * fx, fy * (1 - fx), fy * fx)


def _blend(w: torch.Tensor, weights, size: int) -> torch.Tensor:
    """4-tap blend of (..., size+1, size+1) windows."""
    a00, a01, a10, a11 = weights
    return (a00 * w[..., :size, :size] + a01 * w[..., :size, 1:]
            + a10 * w[..., 1:, :size] + a11 * w[..., 1:, 1:])


def _bilinear_window(screen: torch.Tensor, offset_rc: np.ndarray,
                     size: int) -> torch.Tensor:
    """Periodic bilinear (size, size) window at a host float32 offset.

    The integer part picks one slice of the wrap-padded screen, its start
    wrapped into [0, N) by a non-negative modulo (as jnp.mod does); the
    fractional part is the 4-tap blend.
    """
    N = screen.shape[0] - (size + 1)
    oy, ox = np.float32(offset_rc[0]), np.float32(offset_rc[1])
    iy, ix = np.floor(oy), np.floor(ox)
    r0, c0 = int(iy) % N, int(ix) % N
    w = screen[r0:r0 + size + 1, c0:c0 + size + 1]
    weights = [float(a) for a in _weights(oy - iy, ox - ix)]
    return _blend(w, weights, size)


def _bilinear_windows(screens: torch.Tensor, offsets: torch.Tensor,
                      size: int) -> torch.Tensor:
    """Batched windows: offsets (B, L, 2) float32 -> (B, L, size, size)."""
    N = screens.shape[-1] - (size + 1)
    floor = torch.floor(offsets)
    frac = (offsets - floor)[..., None, None]    # (B, L, 2, 1, 1)
    start = torch.remainder(floor.to(torch.int64), N)
    ar = torch.arange(size + 1, device=screens.device)
    rows = start[..., 0, None] + ar              # (B, L, size+1)
    cols = start[..., 1, None] + ar
    layer = torch.arange(screens.shape[0], device=screens.device)
    w = screens[layer[None, :, None, None], rows[..., :, None],
                cols[..., None, :]]              # (B, L, size+1, size+1)
    return _blend(w, _weights(frac[:, :, 0], frac[:, :, 1]), size)


def phase_at(layers: FrozenFlowLayers, step, resolution: int) -> torch.Tensor:
    """Summed multi-layer pupil phase at time step ``step`` (may be
    fractional; the window slides continuously).  NOT piston-removed.

    ``step`` is either a host number -- one window shared by every
    scenario, offsets computed on the host, result (R, R) -- or a (B,)
    tensor of per-scenario steps, gathered on the device, result
    (B, R, R).  Offsets are float32 products step_px * step, as in the
    JAX package, so both give the same windows.
    """
    if isinstance(step, torch.Tensor):
        offsets = layers.step_px * step.to(torch.float32)[:, None, None]
        win = _bilinear_windows(layers.screens, offsets, resolution)
        out = win[:, 0]
        for i in range(1, layers.n_layers):
            out = out + win[:, i]
        return out
    offsets = layers.step_px_host * np.float32(step)
    out = _bilinear_window(layers.screens[0], offsets[0], resolution)
    for i in range(1, layers.n_layers):
        out = out + _bilinear_window(layers.screens[i], offsets[i],
                                     resolution)
    return out


def piston_removed_phase_at_ref(layers: FrozenFlowLayers,
                                step: torch.Tensor, resolution: int,
                                mask: torch.Tensor,
                                mask_npix) -> torch.Tensor:
    """Plain PyTorch version of kernel T1: ``phase_at`` at the (B,)
    per-scenario steps, then ``zernike.piston_removed_phase_masked``."""
    raw = phase_at(layers, step, resolution)
    return zernike.piston_removed_phase_masked(raw, mask, mask_npix)


def piston_removed_phase_at(layers: FrozenFlowLayers, step: torch.Tensor,
                            resolution: int, mask: torch.Tensor,
                            mask_npix) -> torch.Tensor:
    """Kernel T1: the piston-removed, masked pupil phase (B, R, R) at a
    (B,) float32 tensor of per-scenario steps -- each scenario's window
    gather, bilinear blend, layer sum and piston removal in one pass
    (csrc/phase_window.cu).

    On a CUDA tensor it launches the kernel (counted in
    ``piston_removed_phase_at.launches``) or raises; on a CPU tensor it
    runs ``piston_removed_phase_at_ref``.  The kernel's phase inside the
    pupil is the plain version's but for the rounding of the mean, whose
    sum it takes in another (fixed) order; outside the pupil it is 0.
    ``mask`` is the (R, R) bool pupil, ``mask_npix`` its pixel count (a
    number, or a 0-d tensor on the device).
    """
    if step.device.type == "cpu":
        return piston_removed_phase_at_ref(layers, step, resolution, mask,
                                           mask_npix)
    dev = step.device
    R = resolution
    L, Ns = layers.screens.shape[0], layers.screens.shape[-1]
    if step.dim() != 1:
        raise ValueError(f"step must be (B,), got {tuple(step.shape)}")
    B = step.shape[0]
    for label, t, shape, dtype in (
            ("step", step, (B,), torch.float32),
            ("screens", layers.screens, (L, Ns, Ns), torch.float32),
            ("step_px", layers.step_px, (L, 2), torch.float32),
            ("mask", mask, (R, R), torch.bool)):
        if t.device != dev:
            raise ValueError(f"{label} is on {t.device}, expected {dev}")
        if t.dtype != dtype:
            raise TypeError(f"{label} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{label} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{label} must be contiguous")
    if Ns <= R + 1:
        raise ValueError(f"screens of {Ns} px hold no {R}-px window")
    npix = torch.as_tensor(mask_npix, dtype=torch.float32, device=dev)
    # scenarios in the order of their steps: neighbours' windows overlap,
    # so the clusters in flight share their taps in L2
    order = torch.argsort(step)
    out = torch.empty((B, R, R), dtype=torch.float32, device=dev)
    launch = cuda_build.function(
        "phase_window", [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
        + [ctypes.c_void_p])
    launch(*(t.data_ptr() for t in (layers.screens, layers.step_px, step,
                                    mask, npix, order, out)),
           B, L, Ns, R, dev.index, torch.cuda.current_stream(dev).cuda_stream)
    piston_removed_phase_at.launches += 1
    return out


piston_removed_phase_at.launches = 0
