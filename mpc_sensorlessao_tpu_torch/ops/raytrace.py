"""Paraxial ABCD ray tracing (port of ``mpc_sensorlessao_tpu/ops/raytrace.py``;
the reference's +rayTracing package: abcd.m, freeSpace.m, thinLens.m,
curvedMirror.m).

2x2 paraxial transfer matrices applied to (offset, angle) ray vectors,
with element transverse offsets, stop vignetting and z-propagation
direction.  Elements are plain (matrix, offset, stop) records, a system
is their list, and ``trace``/``trace_path`` run over RAY BATCHES
(..., 2) -- a million rays is one (N, 2) x (2, 2) matmul chain on the
rays' device.  ``system_matrix`` collapses any offset-free chain into a
single host float64 2x2 matrix.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Sequence

import numpy as np
import torch


class Element(NamedTuple):
    """One paraxial element.

    matrix:    (2, 2) float64 host ABCD matrix (moved to the rays' device
               and dtype when applied);
    offset:    transverse element decenter [m] (abcd.m:48 subtracts it
               from the ray offset before the matrix);
    stop_width: aperture full width [m] (inf = no stop); rays with
               |y - stop_offset| > stop_width/2 are vignetted;
    stop_offset: stop decenter [m];
    thickness: z extent [m] (free-space distance);
    z_dir:     +1 forward, -1 after a mirror (abcd.m:18 zPropDir).
    """

    matrix: np.ndarray
    offset: float = 0.0
    stop_width: float = math.inf
    stop_offset: float = 0.0
    thickness: float = 0.0
    z_dir: int = 1


def _f32(m) -> np.ndarray:
    """The matrix as the JAX package stores it: rounded to float32."""
    return np.asarray(m, dtype=np.float32).astype(np.float64)


def free_space(distance: float, **kw) -> Element:
    """[[1, d], [0, 1]] (freeSpace.m:24-26)."""
    return Element(_f32([[1.0, distance], [0.0, 1.0]]),
                   thickness=float(distance), **kw)


def thin_lens(focal_length: float, **kw) -> Element:
    """[[1, 0], [-1/f, 1]] (thinLens.m:23-24)."""
    return Element(_f32([[1.0, 0.0], [-1.0 / focal_length, 1.0]]), **kw)


def curved_mirror(radius: float, **kw) -> Element:
    """[[1, 0], [-2/R, 1]], reverses propagation (curvedMirror.m:22-25)."""
    return Element(_f32([[1.0, 0.0], [-2.0 / radius, 1.0]]), z_dir=-1,
                   **kw)


def apply(elem: Element, rays: torch.Tensor):
    """(..., 2) rays -> (rays_out, pass_mask).

    abcd.relay (abcd.m:46-53): subtract the element decenter from the
    offset row, then multiply; the stop sets the vignette mask.
    """
    y = rays[..., 0] - elem.offset
    a = rays[..., 1]
    shifted = torch.stack([y, a], dim=-1)
    m = torch.as_tensor(elem.matrix, dtype=rays.dtype, device=rays.device)
    out = shifted @ m.T
    ok = torch.abs(y - elem.stop_offset) <= elem.stop_width / 2.0
    return out, ok


def trace(elements: Sequence[Element], rays: torch.Tensor):
    """Propagate a ray batch through the chain.

    Returns (rays_out, vignette_mask, z_total, z_dir): the mask is the AND
    of every stop; z_total accumulates signed thickness (curved mirrors
    flip the direction for the following elements)."""
    ok = torch.ones(rays.shape[:-1], dtype=torch.bool, device=rays.device)
    z = 0.0
    z_dir = 1
    for e in elements:
        rays, ok_e = apply(e, rays)
        ok = ok & ok_e
        z = z + z_dir * e.thickness
        z_dir = z_dir * e.z_dir
    return rays, ok, z, z_dir


def trace_path(elements: Sequence[Element],
               rays: torch.Tensor) -> torch.Tensor:
    """(n_elem+1, ..., 2) ray states at every surface."""
    out = [rays]
    for e in elements:
        rays, _ = apply(e, rays)
        out.append(rays)
    return torch.stack(out)


def system_matrix(elements: Sequence[Element]) -> np.ndarray:
    """Composed 2x2 ABCD matrix of an offset-free chain (host float64);
    raises if any element has an offset (the map is then affine)."""
    M = np.eye(2)
    for e in elements:
        if e.offset != 0.0:
            raise ValueError("system_matrix needs offset-free elements")
        M = np.asarray(e.matrix, dtype=np.float64) @ M
    return M


def effective_focal_length(elements: Sequence[Element]) -> float:
    """f_eff = -1/C of the composed matrix."""
    M = system_matrix(elements)
    if abs(M[1, 0]) < 1e-15:
        return math.inf
    return float(-1.0 / M[1, 0])
