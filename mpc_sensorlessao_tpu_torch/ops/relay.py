"""Source geometry + multi-layer relay projection (NGS off-axis / LGS
cone); port of ``mpc_sensorlessao_tpu/ops/relay.py``.

* direction_vector = (tan(zenith) cos(azimuth), tan(zenith) sin(azimuth))
  (source.m:412-417);
* per-layer projection: a layer at altitude h seen by a source at height
  H is sampled on a pupil footprint of radius R (1 - h/H) (the LGS cone
  effect; H = inf for an NGS) centered at h * direction (off-axis
  anisoplanatism), by bilinear interpolation of the layer screen
  (telescopeAbstract.m:449-487);
* wavelength rescale and airmass factor 1/sqrt(cos(zenith angle))
  (telescopeAbstract.m:490-493).

The projection is a gather-based bilinear interpolation over a batch of
screens: (..., n, n) layers give (..., resolution, resolution) phases, so
a Monte-Carlo over many screens is one call.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch


def direction_vector(zenith: float, azimuth: float):
    """(theta_x, theta_y) transverse direction [rad for small angles]
    (source.m:412-417: tan(zenith) (cos, sin)(azimuth))."""
    return (math.tan(zenith) * math.cos(azimuth),
            math.tan(zenith) * math.sin(azimuth))


def _bilinear(screen: torch.Tensor, rows: torch.Tensor,
              cols: torch.Tensor) -> torch.Tensor:
    """Bilinear sample of (..., n, n) screens at fractional (rows, cols)
    index grids (the same grid for every screen of the batch).

    Out-of-bounds coordinates are clamped to the screen edge (the
    fractional part too, not just the base index), so sampling past the
    border holds the edge value instead of extrapolating; at the last
    row or column the base index is n-2 and the weight 1.
    """
    n = screen.shape[-1]
    rows = torch.clamp(rows, 0.0, n - 1.0)
    cols = torch.clamp(cols, 0.0, n - 1.0)
    r0 = torch.clamp(torch.floor(rows), 0, n - 2).to(torch.int64)
    c0 = torch.clamp(torch.floor(cols), 0, n - 2).to(torch.int64)
    fr = rows - r0
    fc = cols - c0
    flat = screen.reshape(*screen.shape[:-2], n * n)

    def at(r, c):
        return flat[..., (r * n + c).reshape(-1)].reshape(
            *screen.shape[:-2], *r.shape)

    v00 = at(r0, c0)
    v01 = at(r0, c0 + 1)
    v10 = at(r0 + 1, c0)
    v11 = at(r0 + 1, c0 + 1)
    return (v00 * (1 - fr) * (1 - fc) + v01 * (1 - fr) * fc
            + v10 * fr * (1 - fc) + v11 * fr * fc)


def project_layers(
    screens: Sequence[torch.Tensor],
    pitches: Sequence[float],
    telescope_radius: float,
    altitudes: Sequence[float],
    resolution: int,
    direction: tuple[float, float] = (0.0, 0.0),
    source_height: float = math.inf,
    wavelength_ratio: float = 1.0,
    zenith_angle: float = 0.0,
) -> torch.Tensor:
    """Sum layer screens onto a source's pupil footprint.

    Args:
      screens:   per-layer (..., n_k, n_k) phase maps, centered on the
                 telescope axis, grid pitch ``pitches[k]`` [m]; the
                 leading dims are a batch shared by every layer.
      telescope_radius: R [m].
      altitudes: layer heights h_k [m].
      resolution: output grid size (pupil sampling).
      direction: (theta_x, theta_y) source transverse direction.
      source_height: H [m]; inf for an NGS, e.g. 90e3 for a sodium LGS.
      wavelength_ratio: screen wavelength / source wavelength.
      zenith_angle: pointing angle from zenith; phase scales with
                 airmass 1/sqrt(cos(.)).

    Returns (..., resolution, resolution) float32 phase [rad at the
    source wavelength].  Raises ValueError if a footprint leaves its
    screen (static geometry, checked before any device work).
    """
    out = None
    for screen, pitch, h in zip(screens, pitches, altitudes):
        n = screen.shape[-1]
        if math.isinf(source_height):
            layer_r = telescope_radius
        else:
            layer_r = telescope_radius * (1.0 - h / source_height)
        xc = h * direction[0]
        yc = h * direction[1]
        half_extent = (n - 1) / 2.0 * pitch
        reach = abs(layer_r) + max(abs(xc), abs(yc))
        if reach > half_extent + 1e-9:
            raise ValueError(
                f"source footprint (reach {reach:.3f} m) exceeds the "
                f"layer screen half-extent {half_extent:.3f} m at "
                f"altitude {h} m; enlarge the screen or reduce the "
                "off-axis angle")
        # physical coords -> fractional index (screen centered on axis),
        # in float32 as the JAX package computes them
        u = torch.linspace(-1.0, 1.0, resolution, dtype=torch.float32,
                           device=screen.device)
        half = (n - 1) / 2.0
        cols = (u * layer_r + xc) / pitch + half
        rows = (u * layer_r + yc) / pitch + half
        ci, ri = torch.meshgrid(cols, rows, indexing="xy")
        v = _bilinear(screen.to(torch.float32), ri, ci)
        out = v if out is None else out + v
    scale = wavelength_ratio / math.sqrt(math.cos(zenith_angle))
    return out * scale


def cone_compression(altitude: float, source_height: float) -> float:
    """Footprint shrink factor 1 - h/H (telescopeAbstract.m:472)."""
    if math.isinf(source_height):
        return 1.0
    return 1.0 - altitude / source_height
