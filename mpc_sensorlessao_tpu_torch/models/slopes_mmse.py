"""Spatial MMSE wavefront reconstruction from Shack-Hartmann slopes (port
of ``mpc_sensorlessao_tpu/models/slopes_mmse.py``).

Minimum-mean-square-error estimation of the pupil phase on the (nl+1)^2
corner lattice from 2 nl^2 slope measurements,

    phi_hat = C_ox (C_xx + sigma^2 I)^{-1} s,

with both covariance operators Toeplitz-block-Toeplitz (stationary
turbulence statistics on regular lattices): the operator apply is
``ops.toeplitz.matvec`` -- one 2-D convolution per block -- inside a
conjugate-gradient loop over a batch of measurements.

Three reconstructors: one natural guide star (``build``/``reconstruct``,
optionally toward an off-axis science direction or a frozen-flow lag),
multi-guide-star zonal tomography (``build_tomographic``/
``reconstruct_tomographic``), and a laser guide star at finite height
(``build_lgs``/``reconstruct_lgs``: per-layer cone-compressed lattices
interpolated back onto the pupil).

The covariance kernels are built on the host in numpy float64 (an
oversampled FFT quadrature of the Von Karman spectrum, copied from the JAX
package); the operators and the CG run as float32 tensors on ``device``.

Units: slopes in [rad/m] (mean physical phase gradient); phase in [rad].
The ``reconstruct*`` functions accept the [rad/px] output of
``wfs.geometric_slopes`` with its grid pitch and convert.

Batched CG: every row of a batch runs the JAX package's scalar CG (a
``lax.while_loop`` under ``vmap``) -- per-row ``b2``, ``rs`` and
iteration count, and a row stops as soon as its own residual passes its
own tolerance, then stays frozen while the other rows go on.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from ..ops import phase_stats, toeplitz
from ..utils import gridtools
from ..utils.config import AtmosphereConfig

# rows are tested for "all stopped" once every this many iterations (one
# host sync each); frozen rows do not move, so the answer does not depend
# on it
_SYNC_EVERY = 8


@dataclass(frozen=True)
class SlopesMMSE:
    """Precomputed TBT covariance operators (tensors on one device).

    sel: (n_valid,) int64 indices of the valid lenslets in the row-major
    nl^2 lattice and mask2: (2 nl^2,) float 0/1 valid-slope mask of the
    stacked (x, y) lattice, both made once from ``valid`` (host bool
    map)."""

    cxx: toeplitz.TBTOperator      # <s_x s_x> on the nl^2 lattice
    cyy: toeplitz.TBTOperator
    cxy: toeplitz.TBTOperator
    cox: toeplitz.TBTOperator      # <phi s_x>, (nl+1)^2 x nl^2
    coy: toeplitz.TBTOperator
    noise_var: float               # per-slope noise variance [rad^2/m^2]
    valid: np.ndarray              # (nl, nl) bool valid-lenslet map
    n_lenslet: int
    sel: torch.Tensor
    mask2: torch.Tensor

    @property
    def n_phase(self) -> int:
        return (self.n_lenslet + 1) ** 2


def _kernels(atm: AtmosphereConfig, d: float, n_lenslet: int,
             nf: int = 512, sf: int = 4, mmse_dir=(0.0, 0.0),
             lag: float = 0.0):
    """Covariance kernels on the displacement lattices via oversampled
    FFT quadrature (slopesLinearMMSE.m:289-341,350-378).

    Returns (kxx, kyy, kxy) on the (2nl-1)^2 slope-displacement lattice
    and (kox, koy) on the 2nl x 2nl corner-to-center lattice.
    ``mmse_dir``: science-direction offset from the guide star [rad];
    each layer's Cox kernel gains the displacement phasor
    exp(2 i pi h (dtheta . f)).  ``lag`` [s]: frozen-flow temporal
    prediction -- the science phase is taken ``lag`` seconds AFTER the
    slopes, adding the per-layer wind displacement v*lag.
    """
    cxx, cyy, cxy = _slope_kernels_pair(atm, d, n_lenslet, (0.0, 0.0),
                                        nf, sf)
    fx, fy, ff, delta, cov_of = _freq_grid(d, nf, sf)
    two_pi = 2.0 * np.pi

    # corner-phase to slope: corner lattice sits -d/2 off the lenslet
    # centers in both axes; the half-pixel lands on the oversampled
    # lattice when sf is even (offset sf/2)
    if sf % 2:
        raise ValueError("sf must be even (half-subaperture offset)")
    phasor_off = sf // 2
    b0 = nf // 2
    # cross spectrum S_{phi,sx} = U conj(V) W with U = 1 (phase) and
    # V = i 2 pi f_x sinc sinc (slope filter): the conjugate flips the sign
    base_ox = (-1j * two_pi * fx) * np.sinc(d * fx) * np.sinc(d * fy)
    base_oy = (-1j * two_pi * fy) * np.sinc(d * fx) * np.sinc(d * fy)
    off_axis = (mmse_dir[0] != 0.0 or mmse_dir[1] != 0.0
                or lag != 0.0)
    if not off_axis:
        # spectrum is linear in fractional_r0: one combined-W transform
        W = phase_stats.spectrum(ff, atm)
        kox = cov_of(base_ox * W)
        koy = cov_of(base_oy * W)
    else:
        kox = np.zeros((nf, nf))
        koy = np.zeros((nf, nf))
        for il in range(atm.n_layers):
            slab = atm.layer(il)
            Wl = phase_stats.spectrum(ff, slab)
            h = slab.altitudes[0]
            v = slab.wind_speeds[0]
            wd = slab.wind_directions[0]
            # frozen flow: phi(t + lag) samples the layer at +v lag along
            # the wind (x = v cos(dir), y = v sin(dir))
            sx_ = h * mmse_dir[0] + v * lag * np.cos(wd)
            sy_ = h * mmse_dir[1] + v * lag * np.sin(wd)
            phz = np.exp(2j * np.pi * (sx_ * fx + sy_ * fy))
            kox = kox + cov_of(base_ox * Wl * phz)
            koy = koy + cov_of(base_oy * Wl * phz)
    bo = (np.arange(-n_lenslet + 1, n_lenslet + 1) * sf - phasor_off + b0)
    kox = kox[np.ix_(bo, bo)]
    koy = koy[np.ix_(bo, bo)]
    return cxx, cyy, cxy, kox, koy


def _valid_fields(valid, device) -> dict:
    """``valid``, ``sel`` and ``mask2`` of a reconstructor, from the
    (nl, nl) valid-lenslet map."""
    valid = np.asarray(valid, dtype=bool)
    m = valid.ravel().astype(np.float32)
    return dict(valid=valid,
                sel=torch.as_tensor(np.flatnonzero(m), device=device),
                mask2=torch.as_tensor(np.concatenate([m, m]), device=device))


def build(atm: AtmosphereConfig, diameter: float, n_lenslet: int,
          valid, noise_var: float, nf: int = 512, sf: int = 4,
          mag: float = 1.0, mmse_dir=(0.0, 0.0), lag: float = 0.0,
          device: torch.device | str = "cuda") -> SlopesMMSE:
    """Build the reconstructor for an NGS guide star.

    ``valid``: (nl, nl) bool valid-lenslet map (wfs.SHModel.valid);
    ``noise_var``: per-slope measurement noise variance [rad^2/m^2];
    ``mag``: turbulence magnification (scales covariances by mag^2);
    ``mmse_dir``: (theta_x, theta_y) [rad] science direction relative to
    the guide star -- (0, 0) reconstructs the sensed direction;
    ``lag`` [s]: predict the wavefront this long AFTER the measurement.
    """
    d = diameter / n_lenslet
    kxx, kyy, kxy, kox, koy = _kernels(atm, d, n_lenslet, nf, sf,
                                       mmse_dir=tuple(mmse_dir), lag=lag)
    m2 = float(mag) ** 2
    nl = n_lenslet
    return SlopesMMSE(
        cxx=toeplitz.build((nl, nl), (nl, nl), kxx * m2, device),
        cyy=toeplitz.build((nl, nl), (nl, nl), kyy * m2, device),
        cxy=toeplitz.build((nl, nl), (nl, nl), kxy * m2, device),
        cox=toeplitz.build((nl + 1, nl), (nl + 1, nl), kox * m2, device),
        coy=toeplitz.build((nl + 1, nl), (nl + 1, nl), koy * m2, device),
        noise_var=float(np.float32(noise_var)), n_lenslet=nl,
        **_valid_fields(valid, device))


def _apply_cxx(model, v: torch.Tensor) -> torch.Tensor:
    """(C_xx + sigma^2 I) v on the masked full lattice, v = (..., 2 nl^2).

    Invalid-lenslet entries are zeroed in and out, with the noise diagonal
    keeping those rows trivially invertible.
    """
    mask2 = model.mask2
    vm = v * mask2
    sx, sy = torch.chunk(vm, 2, dim=-1)
    yx = toeplitz.matvec(model.cxx, sx) + toeplitz.matvec(model.cxy, sy)
    yy = (toeplitz.matvec(toeplitz.transpose(model.cxy), sx)
          + toeplitz.matvec(model.cyy, sy))
    out = torch.cat([yx, yy], dim=-1) * mask2
    # identity on INVALID rows uses the pre-mask input so those
    # coordinates are trivially invertible (not mapped to zero)
    return out + model.noise_var * vm + (1.0 - mask2) * v


def _cg(matvec, b: torch.Tensor, tol: float, maxit: int):
    """Conjugate gradient on a batch b (B, n) of SPD systems, each row the
    JAX package's scalar loop: it runs while ``it < maxit`` and ``rs >
    tol^2 b2`` of its own, and a stopped row keeps its state.  Returns
    (x, iterations) with iterations (B,) int64."""
    b2 = torch.sum(b * b, dim=-1)
    x = torch.zeros_like(b)
    r, p, rs = b, b, b2
    it = torch.zeros(b.shape[0], dtype=torch.int64, device=b.device)
    thresh = tol ** 2 * b2
    for k in range(maxit):
        active = rs > thresh          # it < maxit holds for every row here
        if k % _SYNC_EVERY == 0 and not bool(active.any()):
            break
        Ap = matvec(p)
        alpha = rs / (torch.sum(p * Ap, dim=-1) + 1e-30)
        x_new = x + alpha[:, None] * p
        r_new = r - alpha[:, None] * Ap
        rs_new = torch.sum(r_new * r_new, dim=-1)
        p_new = r_new + (rs_new / (rs + 1e-30))[:, None] * p
        a = active[:, None]
        x = torch.where(a, x_new, x)
        r = torch.where(a, r_new, r)
        p = torch.where(a, p_new, p)
        rs = torch.where(active, rs_new, rs)
        it = it + active.to(it.dtype)
    return x, it


def _scatter(model, slopes: torch.Tensor, pitch: float) -> torch.Tensor:
    """(..., 2 n_valid) [rad/px] -> (..., 2 nl^2) [rad/m] on the full
    lattice, zero at invalid lenslets."""
    nl2 = model.n_lenslet ** 2
    n_valid = slopes.shape[-1] // 2
    if n_valid != model.sel.numel():
        raise ValueError(f"{2 * n_valid} slopes for "
                         f"{model.sel.numel()} valid lenslets")
    full = slopes.new_zeros(*slopes.shape[:-1], 2, nl2)
    full[..., 0, model.sel] = slopes[..., :n_valid] / pitch
    full[..., 1, model.sel] = slopes[..., n_valid:] / pitch
    return full.reshape(*slopes.shape[:-1], 2 * nl2)


def reconstruct(model: SlopesMMSE, slopes: torch.Tensor, pitch: float,
                tol: float = 5e-2, maxit: int = 100) -> torch.Tensor:
    """Slopes -> (..., nl+1, nl+1) phase map [rad].

    ``slopes``: (..., 2 n_valid) [rad/px] from wfs.geometric_slopes (x
    block then y block), any leading batch dims; ``pitch``: phase-grid
    pixel pitch [m] (converts to rad/m).  Each row's CG iteration count
    is ``solve(...)[1]``.
    """
    lead = slopes.shape[:-1]
    y, _ = solve(model, slopes.reshape(-1, slopes.shape[-1]), pitch, tol,
                 maxit)
    yx, yy = torch.chunk(y, 2, dim=-1)
    phi = toeplitz.matvec(model.cox, yx) + toeplitz.matvec(model.coy, yy)
    return phi.reshape(*lead, model.n_lenslet + 1, model.n_lenslet + 1)


# ---------------------------------------------------------------------------
# Multi-guide-star zonal tomography (slopesLinearMMSE.m NGS meta-matrix,
# :110-127 -- slope-slope covariances over direction pairs)
# ---------------------------------------------------------------------------

def _freq_grid(d: float, nf: int, sf: int):
    """Shared oversampled frequency grid + quadrature for every kernel
    builder: C(Delta) = int S(f) e^{i 2 pi f Delta} df ~= ifft2 * N^2 d^2
    with the fftshift sandwich putting Delta = 0 at the center index."""
    lf = sf / (2.0 * d)
    f1 = (np.arange(nf) - nf // 2) / (nf // 2) * lf
    fx, fy = np.meshgrid(f1, f1)
    ff = np.hypot(fx, fy)
    delta = 2.0 * lf / nf

    def cov_of(spec):
        c = np.fft.fftshift(np.fft.ifft2(np.fft.ifftshift(spec)))
        return np.real(c) * (delta * nf) ** 2

    return fx, fy, ff, delta, cov_of


def _slope_kernels_pair(atm: AtmosphereConfig, d: float, n_lenslet: int,
                        dtheta, nf: int = 512, sf: int = 4):
    """Slope-slope covariance kernels between two apertures separated by
    the field angle ``dtheta`` [rad]: per-layer displacement phasors
    exp(2 i pi h (dtheta . f)) on the (xx, yy, xy) spectra.  On-axis
    pairs collapse to one combined-W transform (spectrum linear in
    fractional_r0)."""
    fx, fy, ff, delta, cov_of = _freq_grid(d, nf, sf)
    sinc2 = (np.sinc(d * fx) * np.sinc(d * fy)) ** 2
    two_pi = 2.0 * np.pi

    off = dtheta[0] != 0.0 or dtheta[1] != 0.0
    if not off:
        specs = [(phase_stats.spectrum(ff, atm), 1.0)]
    else:
        specs = []
        for il in range(atm.n_layers):
            slab = atm.layer(il)
            h = slab.altitudes[0]
            specs.append((phase_stats.spectrum(ff, slab),
                          np.exp(2j * np.pi * h * (dtheta[0] * fx
                                                   + dtheta[1] * fy))))
    kxx = np.zeros((nf, nf))
    kyy = np.zeros((nf, nf))
    kxy = np.zeros((nf, nf))
    for W, phz in specs:
        kxx += cov_of((two_pi * fx) ** 2 * sinc2 * W * phz)
        kyy += cov_of((two_pi * fy) ** 2 * sinc2 * W * phz)
        kxy += cov_of((two_pi ** 2) * fx * fy * sinc2 * W * phz)
    b0 = nf // 2
    bs = (np.arange(-(n_lenslet - 1), n_lenslet) * sf + b0)
    return (kxx[np.ix_(bs, bs)], kyy[np.ix_(bs, bs)], kxy[np.ix_(bs, bs)])


@dataclass(frozen=True)
class SlopesTomography:
    """Multi-GS zonal MMSE reconstructor (TBT blocks per direction pair).

    cxx_blocks: tuple over flattened (i, j) i<=j pairs of (xx, yy, xy)
    TBTOperators; cxx_blocks_t the same pre-transposed (the j < i half);
    cox_blocks: tuple over GS of (ox, oy) operators toward the science
    direction."""

    cxx_blocks: tuple
    cxx_blocks_t: tuple
    cox_blocks: tuple
    noise_var: float
    valid: np.ndarray
    n_lenslet: int
    n_gs: int
    sel: torch.Tensor
    mask2: torch.Tensor


def build_tomographic(atm: AtmosphereConfig, diameter: float,
                      n_lenslet: int, valid, noise_var: float,
                      gs_dirs, mmse_dir=(0.0, 0.0), nf: int = 512,
                      sf: int = 4, mag: float = 1.0,
                      device: torch.device | str = "cuda"
                      ) -> SlopesTomography:
    """Multi-guide-star zonal tomography: estimate the science-direction
    pupil phase from the stacked slopes of several NGS."""
    d = diameter / n_lenslet
    nl = n_lenslet
    m2 = float(mag) ** 2
    dirs = [np.asarray(g, dtype=np.float64) for g in gs_dirs]
    sci = np.asarray(mmse_dir, dtype=np.float64)
    n_gs = len(dirs)

    def tbt(shape, k):
        return toeplitz.build(shape, shape, k * m2, device)

    cxx = []
    for i in range(n_gs):
        for j in range(i, n_gs):
            kxx, kyy, kxy = _slope_kernels_pair(
                atm, d, nl, tuple(dirs[i] - dirs[j]), nf, sf)
            cxx.append(tuple(tbt((nl, nl), k) for k in (kxx, kyy, kxy)))
    cox = []
    for g in dirs:
        _, _, _, kox, koy = _kernels(atm, d, nl, nf, sf,
                                     mmse_dir=tuple(sci - g))
        cox.append((tbt((nl + 1, nl), kox), tbt((nl + 1, nl), koy)))
    cxx_t = tuple(tuple(toeplitz.transpose(op) for op in blk)
                  for blk in cxx)
    return SlopesTomography(
        cxx_blocks=tuple(cxx), cxx_blocks_t=cxx_t, cox_blocks=tuple(cox),
        noise_var=float(np.float32(noise_var)), n_lenslet=nl, n_gs=n_gs,
        **_valid_fields(valid, device))


def _pair_index(i, j, n):
    """Flat index of the upper-triangular (i, j), i <= j."""
    return i * n - i * (i - 1) // 2 + (j - i)


def _apply_block(blocks, v: torch.Tensor) -> torch.Tensor:
    """Apply one (xx, yy, xy) TBT block pair to v = (..., 2 nl^2).

    The x<->y cross blocks BOTH use the same operator: C_{sx,sy} and
    C_{sy,sx} come from the identical even kernel k_xy, so the dense
    blocks are equal -- not transposes -- for displaced aperture pairs.
    """
    bxx, byy, bxy = blocks
    sx, sy = torch.chunk(v, 2, dim=-1)
    yx = toeplitz.matvec(bxx, sx) + toeplitz.matvec(bxy, sy)
    yy_ = toeplitz.matvec(bxy, sx) + toeplitz.matvec(byy, sy)
    return torch.cat([yx, yy_], dim=-1)


def _apply_cxx_tomo(model: SlopesTomography,
                    v: torch.Tensor) -> torch.Tensor:
    """(C_xx + sigma^2 I) v over the stacked (..., n_gs * 2 nl^2)
    lattice."""
    nl = model.n_lenslet
    n_gs = model.n_gs
    mask2 = model.mask2
    V = v.reshape(*v.shape[:-1], n_gs, 2 * nl * nl)
    Vm = V * mask2
    out = []
    for i in range(n_gs):
        acc = 0.0
        for j in range(n_gs):
            if i <= j:
                blk = model.cxx_blocks[_pair_index(i, j, n_gs)]
            else:
                blk = model.cxx_blocks_t[_pair_index(j, i, n_gs)]
            acc = acc + _apply_block(blk, Vm[..., j, :])
        out.append(acc * mask2 + model.noise_var * Vm[..., i, :]
                   + (1.0 - mask2) * V[..., i, :])
    return torch.stack(out, dim=-2).reshape(v.shape)


def reconstruct_tomographic(model: SlopesTomography, slopes: torch.Tensor,
                            pitch: float, tol: float = 5e-2,
                            maxit: int = 150) -> torch.Tensor:
    """(..., n_gs, 2 n_valid) stacked guide-star slopes [rad/px] ->
    (..., nl+1, nl+1) science-direction phase [rad]."""
    nl = model.n_lenslet
    lead = slopes.shape[:-2]
    y, _ = solve(model, slopes.reshape(-1, *slopes.shape[-2:]), pitch, tol,
                  maxit)
    Y = y.reshape(-1, model.n_gs, 2, nl * nl)
    phi = 0.0
    for g in range(model.n_gs):
        ox, oy = model.cox_blocks[g]
        phi = phi + toeplitz.matvec(ox, Y[:, g, 0]) \
            + toeplitz.matvec(oy, Y[:, g, 1])
    return phi.reshape(*lead, nl + 1, nl + 1)


# ---------------------------------------------------------------------------
# Laser guide star: finite-height cone geometry (slopesLinearMMSE.m LGS
# branch, :128-156 -- per-layer compressed lattices + interpolation back
# onto the pupil)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class LGSSlopesMMSE:
    """Finite-height (cone-beam) slopes-MMSE reconstructor.

    An LGS at height H samples layer h on a footprint compressed by
    g = 1 - h/H, so the slope covariances live on per-layer g-compressed
    lattices.  Each LAYER's phase is MMSE-estimated on its own padded
    compressed lattice (Cox per layer, pad = ceil(nl (1-g) / (2 g))) and
    interpolated back onto the pupil corner lattice with a dense bilinear
    matrix (utils.gridtools.bilinear_interp_matrix).  Each layer's slope
    filter is i 2 pi f g sinc(g d fx) sinc(g d fy) on its compressed
    lattice (amplitude g, the JAX package's validated convention).

    Fields mirror SlopesMMSE (so ``_apply_cxx`` and the CG are shared)
    plus the per-layer Cox operators and interpolation matrices.
    """

    cxx: toeplitz.TBTOperator
    cyy: toeplitz.TBTOperator
    cxy: toeplitz.TBTOperator
    cox_layers: tuple          # per layer: (ox, oy) ((nl+1+2p)^2 x nl^2)
    interp: tuple              # per layer: ((nl+1)^2, (nl+1+2p)^2) tensor
    noise_var: float
    valid: np.ndarray
    n_lenslet: int
    sel: torch.Tensor
    mask2: torch.Tensor


def _cone_cox_kernels(slab, d: float, g: float, n_lenslet: int, pad: int,
                      nf: int, sf: int, mmse_dir=(0.0, 0.0)):
    """Corner-phase-to-slope kernels for ONE layer on its g-compressed
    lattice, padded to cover the (uncompressed) science footprint."""
    if sf % 2:
        raise ValueError("sf must be even (half-subaperture offset)")
    fx, fy, ff, delta, cov_of = _freq_grid(d * g, nf, sf)
    h = slab.altitudes[0]
    base = g * np.sinc(g * d * fx) * np.sinc(g * d * fy)
    W = phase_stats.spectrum(ff, slab)
    if mmse_dir[0] != 0.0 or mmse_dir[1] != 0.0:
        # science-direction offset phasor (deltaSrc = h * (gs - mmse))
        W = W * np.exp(2j * np.pi * h * (mmse_dir[0] * fx
                                         + mmse_dir[1] * fy))
    kox = cov_of((-1j * 2.0 * np.pi * fx) * base * W)
    koy = cov_of((-1j * 2.0 * np.pi * fy) * base * W)
    b0 = nf // 2
    bo = (np.arange(-n_lenslet + 1 - pad, n_lenslet + 1 + pad) * sf
          - sf // 2 + b0)
    if bo.min() < 0 or bo.max() >= nf:
        raise ValueError("padded lattice exceeds the FFT quadrature "
                         "grid; raise nf or lower sf")
    return kox[np.ix_(bo, bo)], koy[np.ix_(bo, bo)]


def build_lgs(atm: AtmosphereConfig, diameter: float, n_lenslet: int,
              valid, noise_var: float, lgs_height: float,
              nf: int = 512, sf: int = 4, mag: float = 1.0,
              mmse_dir=(0.0, 0.0),
              device: torch.device | str = "cuda") -> LGSSlopesMMSE:
    """Build the cone-geometry reconstructor for an LGS at ``lgs_height``
    [m] (e.g. 90e3 sodium, 10-20e3 Rayleigh).

    ``mmse_dir``: science direction relative to the guide star [rad].
    The estimate is the infinite-height (science) pupil phase on the
    (nl+1)^2 corner lattice, assembled from per-layer estimates.
    """
    d = diameter / n_lenslet
    nl = n_lenslet
    m2 = float(mag) ** 2
    kxx = np.zeros((2 * nl - 1, 2 * nl - 1))
    kyy = np.zeros_like(kxx)
    kxy = np.zeros_like(kxx)
    cox_ops = []
    interps = []
    corner_1d = (np.arange(nl + 1) - nl / 2.0) * d
    ci, cj = np.meshgrid(corner_1d, corner_1d, indexing="ij")  # (y, x)
    for il in range(atm.n_layers):
        slab = atm.layer(il)
        h = slab.altitudes[0]
        g = 1.0 - h / lgs_height
        if g <= 0:
            raise ValueError(f"layer altitude {h} above the guide star")
        a, b, c = _slope_kernels_pair(slab, d * g, nl, (0.0, 0.0), nf, sf)
        kxx += g * g * a
        kyy += g * g * b
        kxy += g * g * c
        pad = int(np.ceil(0.5 * nl * (1.0 - g) / g)) if g < 1.0 else 0
        kox, koy = _cone_cox_kernels(slab, d, g, nl, pad, nf, sf,
                                     mmse_dir=tuple(mmse_dir))
        npl = nl + 1 + 2 * pad
        cox_ops.append((
            toeplitz.build((npl, nl), (npl, nl), kox * m2, device),
            toeplitz.build((npl, nl), (npl, nl), koy * m2, device)))
        lat_1d = (np.arange(npl) - pad - nl / 2.0) * (g * d)
        li, lj = np.meshgrid(lat_1d, lat_1d, indexing="ij")
        interps.append(torch.as_tensor(gridtools.bilinear_interp_matrix(
            cj, ci, lj, li, g * d), dtype=torch.float32, device=device))
    return LGSSlopesMMSE(
        cxx=toeplitz.build((nl, nl), (nl, nl), kxx * m2, device),
        cyy=toeplitz.build((nl, nl), (nl, nl), kyy * m2, device),
        cxy=toeplitz.build((nl, nl), (nl, nl), kxy * m2, device),
        cox_layers=tuple(cox_ops), interp=tuple(interps),
        noise_var=float(np.float32(noise_var)), n_lenslet=nl,
        **_valid_fields(valid, device))


def reconstruct_lgs(model: LGSSlopesMMSE, slopes: torch.Tensor,
                    pitch: float, tol: float = 5e-2,
                    maxit: int = 100) -> torch.Tensor:
    """LGS slopes (..., 2 n_valid) [rad/px] -> (..., nl+1, nl+1) science
    pupil phase [rad]: CG on the shared (Cxx + sigma^2) operator, then
    per-layer Cox apply + bilinear interpolation sum."""
    lead = slopes.shape[:-1]
    y, _ = solve(model, slopes.reshape(-1, slopes.shape[-1]), pitch, tol,
                 maxit)
    yx, yy = torch.chunk(y, 2, dim=-1)
    phi = 0.0
    for (ox, oy), B in zip(model.cox_layers, model.interp):
        phi_l = toeplitz.matvec(ox, yx) + toeplitz.matvec(oy, yy)
        phi = phi + phi_l @ B.T
    nl = model.n_lenslet
    return phi.reshape(*lead, nl + 1, nl + 1)


# ---------------------------------------------------------------------------
# The CG stage alone, and its true residual
# ---------------------------------------------------------------------------

def _operator(model):
    return (_apply_cxx_tomo if isinstance(model, SlopesTomography)
            else _apply_cxx)


def solve(model, slopes: torch.Tensor, pitch: float, tol: float = 5e-2,
          maxit: int = 100):
    """The CG stage of any of the three reconstructors: slopes (B, ...)
    [rad/px] -> (y, iterations), y (B, n) the solution of
    (C_xx + sigma^2 I) y = c on the full lattice (c the scattered slopes
    [rad/m]); iterations (B,) int64."""
    c = _scatter(model, slopes, pitch).reshape(slopes.shape[0], -1)
    return _cg(lambda v: _operator(model)(model, v), c, tol, maxit)


def _float64(v):
    if isinstance(v, toeplitz.TBTOperator):
        return toeplitz.of_generator(v.gen.double(), v.n_block, v.n_inner)
    if isinstance(v, tuple):
        return tuple(_float64(w) for w in v)
    return v


def relative_residual(model, slopes: torch.Tensor, pitch: float,
                      y: torch.Tensor) -> torch.Tensor:
    """(B,) float64 ||c - (C_xx + sigma^2 I) y|| / ||c|| with the operator
    applied in float64: the TRUE residual of a CG answer ``y`` (``solve``),
    which the JAX stopping rule bounds by ``tol`` in exact arithmetic."""
    m64 = dataclasses.replace(model, **{
        f.name: _float64(getattr(model, f.name))
        for f in dataclasses.fields(model)})
    c = _scatter(model, slopes, pitch).reshape(slopes.shape[0], -1).double()
    r = c - _operator(model)(m64, y.double())
    return torch.linalg.norm(r, dim=-1) / torch.linalg.norm(c, dim=-1)
