"""Von Karman phase screens and their frozen-flow windows, float64.

Each layer is one periodic FFT screen (the spectral method with
subharmonic low-frequency patches, Lane et al. 1992) drawn from its own
integer seed: the normal draws are the inputs the configuration fixes,
taken from ``numpy.random.default_rng(SeedSequence([seed]))`` in the
order the method consumes them (the (N, N) white field, then per
subharmonic level 8 cosine and 8 sine amplitudes).  The screens are
stored in float32, as the configuration states for the turbulence data;
everything computed from them here is float64.

A window at step s starts at the layer's wind shift times s, both
rounded to float32 as the configuration's step grid states, and is the
4-tap bilinear blend of the periodic screen at that offset.
"""

from __future__ import annotations

import math

import numpy as np
import torch

# (24/5 Gamma(6/5))^(5/6) Gamma(11/6)^2 / (2 pi^(11/3)): the Von Karman
# phase PSD constant, W(f) = PSD_CONST r0^(-5/3) (f^2 + L0^-2)^(-11/6)
PSD_CONST = ((24.0 * math.gamma(6.0 / 5.0) / 5.0) ** (5.0 / 6.0)
             * math.gamma(11.0 / 6.0) ** 2 / (2.0 * math.pi ** (11.0 / 3.0)))


def spectrum(f, atm: dict, weight: float):
    """Phase PSD [rad^2 m^2] at spatial frequency f [1/m], scaled by the
    layer weight (the fractional r0 of one layer, or their sum)."""
    return (PSD_CONST * atm["r0"] ** (-5.0 / 3.0)
            * (f * f + 1.0 / atm["L0"] ** 2) ** (-11.0 / 6.0) * weight)


def layer_seeds(seed: int, n_layers: int) -> list[int]:
    """The integer seed of each layer's screen."""
    return [int(seed) * 1000003 + i for i in range(n_layers)]


def screen(seed: int, atm: dict, weight: float, n: int, pitch: float,
           device) -> torch.Tensor:
    """One periodic (n, n) screen [rad], rounded to float32 (returned as
    float64 values)."""
    rng = np.random.default_rng(np.random.SeedSequence([int(seed)]))
    white = torch.as_tensor(rng.standard_normal((n, n)), device=device)
    df = 1.0 / (n * pitch)
    fx = torch.fft.fftfreq(n, d=pitch, dtype=torch.float64, device=device)
    fr = torch.sqrt(fx[:, None] ** 2 + fx[None, :] ** 2)
    root = torch.sqrt(spectrum(fr, atm, weight))
    root[0, 0] = 0.0
    spec = torch.fft.fft2(white) / n
    out = torch.fft.ifft2(root * spec).real * (n * n) * df
    x = torch.arange(n, dtype=torch.float64, device=device) * pitch
    for level in range(1, atm["subharmonic_levels"] + 1):
        dfl = df / 3.0 ** level
        freqs = [(p * dfl, q * dfl) for p in (-1, 0, 1) for q in (-1, 0, 1)
                 if (p, q) != (0, 0)]
        amp = [math.sqrt(spectrum(math.hypot(fp, fq), atm, weight)) * dfl
               for fp, fq in freqs]
        a = rng.standard_normal(len(freqs)) * amp
        b = rng.standard_normal(len(freqs)) * amp
        for (fp, fq), ak, bk in zip(freqs, a, b):
            arg = 2.0 * math.pi * (x[:, None] * fp + x[None, :] * fq)
            out = out + ak * torch.cos(arg) + bk * torch.sin(arg)
    return out.float().double()


class Screens:
    """All layers of one atmosphere: the periodic screens and each
    layer's float32 wind shift a step in (row, col) pixels."""

    def __init__(self, seed: int, atm: dict, resolution: int,
                 diameter: float, sampling_freq: float, device):
        self.R = resolution
        pitch = diameter / (resolution - 1)
        n = atm["oversample"] * resolution
        layers = len(atm["altitudes"])
        self.screens = torch.stack([
            screen(s, atm, atm["fractional_r0"][i], n, pitch, device)
            for i, s in enumerate(layer_seeds(seed, layers))])
        shift = []
        for i in range(layers):
            d = atm["wind_speeds"][i] / sampling_freq / pitch
            th = atm["wind_directions"][i]
            shift.append((d * math.sin(th), d * math.cos(th)))
        self.shift = np.asarray(shift, dtype=np.float32)       # (L, 2)

    def phase(self, steps) -> torch.Tensor:
        """Summed layer phase (len(steps), R, R) at the given steps (each
        exactly a float32 number), not piston-removed."""
        steps = np.asarray(steps, dtype=np.float32)
        off = self.shift[None, :, :] * steps[:, None, None]    # float32
        base = np.floor(off)
        frac = torch.as_tensor((off - base).astype(np.float64),
                               device=self.screens.device)     # (S, L, 2)
        n = self.screens.shape[-1]
        start = torch.as_tensor(np.mod(base.astype(np.int64), n),
                                device=self.screens.device)
        ar = torch.arange(self.R + 1, device=self.screens.device)
        rows = (start[..., 0, None] + ar) % n                  # (S, L, R+1)
        cols = (start[..., 1, None] + ar) % n
        lay = torch.arange(self.screens.shape[0],
                           device=self.screens.device)
        win = self.screens[lay[None, :, None, None], rows[..., :, None],
                           cols[..., None, :]]         # (S, L, R+1, R+1)
        fy = frac[..., 0, None, None]
        fx = frac[..., 1, None, None]
        R = self.R
        out = ((1 - fy) * (1 - fx) * win[..., :R, :R]
               + (1 - fy) * fx * win[..., :R, 1:]
               + fy * (1 - fx) * win[..., 1:, :R]
               + fy * fx * win[..., 1:, 1:])
        return out.sum(dim=1)
