"""Hexagonal segmented-pupil geometry and piston/tip/tilt modes (port of
``mpc_sensorlessao_tpu/ops/segmented.py``, a numpy copy).

Equivalent of the reference's `hexagonalPistonTipTilt` influence-function
class (OOMAO-master/hexagonalPistonTipTilt.m:46-75) and the
`utilities.hexagonalArray` layout helper (utilities.m:562-599) plus the
hexagonal branch of `utilities.piston` (utilities.m:52-53).  The PTT
mode stack plugs into the same modal machinery as the Zernike / DM
influence bases: project with ops.zernike.fit or feed models/dm's
modal-influence projection.

All construction is host-side numpy float64 (setup path); the returned
stacks are plain arrays, moved to a device by the caller.
"""

from __future__ import annotations

import math

import numpy as np


def hexagonal_array(n_cycle: int, pitch: float = 1.0):
    """Centers and vertices of a hexagonal array of hexagonal segments
    (utilities.m:562-599).

    Segments of (flat-to-flat) ``pitch`` arranged in ``n_cycle``
    concentric rings around a central segment; n_segments =
    3 n_cycle^2 + 3 n_cycle + 1 (utilities.m:575).

    Returns (centers, vertices): centers complex (S,) with the central
    segment first at 0; vertices complex (S, 6).
    """
    a = pitch / math.sqrt(3.0)          # hexagon side = circumradius
    hex_v = a * np.exp(1j * (np.arange(6) * math.pi / 3.0 + math.pi / 2.0))
    n_seg = 3 * n_cycle * n_cycle + 3 * n_cycle + 1
    centers = np.zeros(n_seg, dtype=complex)
    vertices = np.zeros((n_seg, 6), dtype=complex)
    vertices[0] = hex_v
    count = 0
    for cycle in range(1, n_cycle + 1):
        for o in range(6):
            zo = cycle * a * math.sqrt(3.0) * np.exp(1j * o * math.pi / 3.0)
            for k in range(cycle):
                zc = zo + k * a * math.sqrt(3.0) * np.exp(
                    1j * (o * math.pi / 3.0 + 2.0 * math.pi / 3.0))
                count += 1
                centers[count] = zc
                vertices[count] = hex_v + zc
    return centers, vertices


def hex_mask(side: float, resolution: int, x0: float = 0.0,
             y0: float = 0.0, span: float | None = None) -> np.ndarray:
    """(R, R) pointy-top hexagonal piston mask (utilities.piston 'hex'
    branch, utilities.m:52-53): vertices at y - y0 = +-side, flats at
    |x - x0| = side sqrt(3)/2, i.e. |y| <= side - |x|/sqrt(3).

    ``span``: full width of the coordinate grid (default: 2*side as in
    the reference where nOut equals twice the hexagon side).
    """
    if span is None:
        span = 2.0 * side
    u = (np.arange(resolution) - (resolution - 1) / 2.0) * (
        span / resolution)
    x = (u[None, :] - x0) / side
    y = (u[:, None] - y0) / side
    s3 = math.sqrt(3.0)
    return ((np.abs(x) <= s3 / 2.0)
            & (np.abs(y) <= x / s3 + 1.0)
            & (np.abs(y) <= -x / s3 + 1.0)).astype(np.float64)


def ptt_basis(n_cycle: int, resolution: int,
              valid: np.ndarray | None = None):
    """Piston/tip/tilt mode stack for a hexagonally-segmented pupil
    (hexagonalPistonTipTilt.m:46-75).

    Per valid segment: the hexagonal piston mask, then tip/tilt planes
    2 (x - xc)/pitch and 2 (y - yc)/pitch inside the mask (unit
    peak-to-valley across the segment flat width, the reference's
    2*buf.*(tip-xc)/pitch normalization at
    hexagonalPistonTipTilt.m:70-72).

    Documented deviation: the reference scales the grid by
    resolution/(2 (nCycle-1)) px/pitch (hexagonalPistonTipTilt.m:52),
    which degenerates at nCycle=1 (7 segments -> division by zero) and
    lets the outer ring overflow the frame; here the array's full
    extent ((2 n_cycle + 1) segment widths point-to-point) is fitted to
    the frame instead.

    Returns (modes, centers, seg_mask): modes (3*S_valid, R, R) float64
    ordered [p0, tip0, tilt0, p1, ...]; centers complex (S,) in meters
    of the unit-pitch layout; seg_mask (R, R) the union pupil.
    """
    centers, _ = hexagonal_array(n_cycle, pitch=1.0)
    n_seg = centers.shape[0]
    if valid is None:
        valid = np.ones(n_seg, dtype=bool)
    valid = np.asarray(valid, dtype=bool)
    # full point-to-point extent: ring n reaches |c| = n (pitch units)
    # plus the segment circumradius 2/sqrt(3)/2... vertex at side = 1/sqrt(3)
    span = 2.0 * (n_cycle * 1.0 + 1.0 / math.sqrt(3.0)) * 1.02
    u = (np.arange(resolution) - (resolution - 1) / 2.0) * (
        span / resolution)
    X = u[None, :].repeat(resolution, axis=0)
    Y = u[:, None].repeat(resolution, axis=1)
    side = 1.0 / math.sqrt(3.0)
    modes = []
    union = np.zeros((resolution, resolution))
    for k in range(n_seg):
        if not valid[k]:
            continue
        xc, yc = centers[k].real, centers[k].imag
        buf = hex_mask(side, resolution, x0=xc, y0=yc, span=span)
        union = np.maximum(union, buf)
        modes.append(buf)
        modes.append(2.0 * buf * (X - xc))     # pitch = 1
        modes.append(2.0 * buf * (Y - yc))
    return np.stack(modes, axis=0), centers, union
