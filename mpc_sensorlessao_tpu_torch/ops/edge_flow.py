"""Conditional-Gaussian frozen-flow screen evolution (port of
``mpc_sensorlessao_tpu/ops/edge_flow.py``; reference:
telescopeAbstract.m:823-901 ``init``, :288-372 ``update``).

* each layer's (n, n) phase screen lives inside an (n+2, n+2) frame whose
  1-pixel border is redrawn by conditional-Gaussian sampling
  X = A Z + B eps (telescopeAbstract.m:898-901), where Z is the 2-pixel
  inner ring of the current phase, A = Cov(X,Z) Cov(Z,Z)^-1 and
  B = chol(Cov(X,X) - A Cov(Z,X)), precomputed once per layer from the
  Von Karman covariance (telescopeAbstract.m:863-884);
* per control step the screen translates along the wind: whole pixels by
  exact shifts that consume a freshly drawn border, and the sub-pixel
  remainder by one output-side bilinear sample that is never written
  back (the stored screen stays on the integer lattice).

The shift schedule of a step depends only on the absolute step index, so
it is computed on the host, in float32 as the JAX package computes it
(the same floor of the same float32 products: a float64 schedule shifts a
screen one step early or late near a pixel boundary).  A step draws
K_max + 1 borders, indexed by round s: round s < K_max draws from the
current phases of every layer and shifts the layers with s < |k|; a round
in which no layer shifts is skipped (its draw would never touch the
state); the last draw, index K_max, is taken after the shifts and feeds
only the fractional output sample.

A state is (L, n, n) -- one realization, shared by every scenario of a
batch -- or (B, L, n, n), one per scenario, each drawing its own border
noise.  The border draws are batched matrix products
(torch.bmm, with float32 accumulation for bfloat16 operators); the JAX
package computes them outside any Pallas kernel too.  Only the JAX
package's vectorized ``advance`` is ported: its ``per_layer`` and
``hybrid`` variants and the ``switch``/``where`` shift selection are TPU
workarounds.
"""

from __future__ import annotations

import math
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

import numpy as np
import torch

from ..utils.config import AtmosphereConfig, TelescopeConfig
from . import phase_screens, phase_stats, zernike

OP_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# host threads synthesizing initial screens (each holds ~1.5 GB at 512 px)
SCREEN_THREADS = 8


@dataclass(frozen=True)
class EdgeFlowModel:
    """Per-layer conditional-Gaussian extension operators.

    A:         (L, nX, nZ) conditional-mean operators (float32 or bf16).
    Bc:        (L, nX, nX) lower Cholesky factors of the conditional
               covariance, in A's dtype.
    outer_idx: (nX,) flat indices of the border ring in the (n+2, n+2)
               frame (row-major flatnonzero order).
    inner_idx: (nZ,) flat indices of the 2-px inner ring in the (n, n)
               phase.
    step_px:   per-layer (row, col) displacement per step [px].
    nsub:      per-layer bound on whole-pixel shifts per step,
               floor(|step|) + 1 per moving axis, else 0.
    size:      n.
    """

    A: torch.Tensor
    Bc: torch.Tensor
    outer_idx: torch.Tensor
    inner_idx: torch.Tensor
    step_px: tuple
    nsub: tuple
    size: int

    @property
    def n_layers(self) -> int:
        return self.A.shape[0]

    @property
    def k_max(self) -> int:
        """Shift rounds a step: the draws a step are k_max + 1."""
        return max((max(ns) for ns in self.nsub), default=0)

    @property
    def n_border(self) -> int:
        return self.Bc.shape[-1]


@dataclass(frozen=True)
class EdgeFlowState:
    """Integer-lattice screens per layer: (L, n, n) or (B, L, n, n)."""

    phases: torch.Tensor


def _ring_masks(n: int, n_inner: int = 2):
    """outerMask / innerMask index sets (telescopeAbstract.m:855-861):
    the 1-px border of the (n+2)^2 frame and the n_inner-px ring at the
    edge of the n^2 phase region, row-major."""
    frame = np.zeros((n + 2, n + 2), dtype=bool)
    frame[0, :] = frame[-1, :] = frame[:, 0] = frame[:, -1] = True
    outer_idx = np.flatnonzero(frame.ravel())

    phase_ring = np.zeros((n, n), dtype=bool)
    phase_ring[:n_inner, :] = phase_ring[-n_inner:, :] = True
    phase_ring[:, :n_inner] = phase_ring[:, -n_inner:] = True
    inner_idx = np.flatnonzero(phase_ring.ravel())
    return outer_idx, inner_idx


def _covariance_matrix(p1: np.ndarray, p2: np.ndarray,
                       atm: AtmosphereConfig, device) -> np.ndarray:
    """phase_stats.covariance_matrix evaluated in float64 torch on
    ``device`` (the same function: |p1 - p2| of the complex-coded points,
    then the Von Karman covariance); returned as host float64."""
    a = torch.as_tensor(np.asarray(p1, np.complex128), device=device)
    b = torch.as_tensor(np.asarray(p2, np.complex128), device=device)
    rho = torch.abs(a[:, None] - b[None, :])
    return phase_stats.covariance(rho, atm, torch).cpu().numpy()


def extension_operators(atm_layer: AtmosphereConfig, n: int, pitch: float,
                        n_inner: int = 2,
                        device: torch.device | str = "cuda"):
    """A, B_chol for one layer (telescopeAbstract.m:863-884), host
    float64; the covariance blocks are evaluated on ``device``.

    Grid positions follow the reference's (0:n+1)*pitch frame meshgrid
    (telescopeAbstract.m:864); only pairwise distances matter.
    """
    outer_idx, inner_idx = _ring_masks(n, n_inner)
    u = np.arange(n + 2) * pitch
    cc, rr = np.meshgrid(u, u, indexing="xy")
    pts_frame = (cc + 1j * rr).ravel()
    # phase pixel (i, j) sits at frame pixel (i+1, j+1)
    pts_phase = pts_frame.reshape(n + 2, n + 2)[1:-1, 1:-1].ravel()

    Zp = pts_phase[inner_idx]
    Xp = pts_frame[outer_idx]
    ZZt = _covariance_matrix(Zp, Zp, atm_layer, device)
    ZXt = _covariance_matrix(Zp, Xp, atm_layer, device)
    XXt = _covariance_matrix(Xp, Xp, atm_layer, device)

    A = np.linalg.solve(ZZt + 1e-12 * np.eye(len(Zp)), ZXt).T  # (nX, nZ)
    BBt = XXt - A @ ZXt
    BBt = 0.5 * (BBt + BBt.T)
    try:
        Bc = np.linalg.cholesky(BBt + 1e-12 * np.eye(len(Xp)))
    except np.linalg.LinAlgError:
        w, V = np.linalg.eigh(BBt)
        Bc = V * np.sqrt(np.clip(w, 0.0, None))
    return A, Bc


def _initial_phases(seeds, atm: AtmosphereConfig, n: int,
                    pitch: float) -> np.ndarray:
    """(len(seeds), L, n, n) non-periodic crops of the oversampled FFT
    screens, layer i of set b from seed seeds[b] * 1000003 + i (the
    reference seeds with fourierPhaseScreen, telescopeAbstract.m:850).
    The screens are synthesized in host threads (numpy releases the
    interpreter lock in its FFTs and array math); each is the same
    function of its seed."""
    jobs = [(int(seed) * 1000003 + i, atm.layer(i))
            for seed in seeds for i in range(atm.n_layers)]

    def one(job):
        return phase_screens.synthesize_screen(job[0], job[1], n,
                                               pitch)[:n, :n]
    with ThreadPoolExecutor(min(len(jobs), SCREEN_THREADS)) as pool:
        screens = list(pool.map(one, jobs))
    return np.stack(screens).reshape(len(seeds), atm.n_layers, n, n)


def build(seed, atm: AtmosphereConfig, tel: TelescopeConfig,
          op_dtype: str = "float32",
          device: torch.device | str = "cuda"):
    """The model and the initial state on ``device``.

    ``op_dtype`` (AtmosphereConfig.edge_op_dtype) stores only A and Bc in
    that dtype; the screens stay float32, and a bfloat16 draw accumulates
    in float32.
    """
    if op_dtype not in OP_DTYPES:
        raise ValueError(f"unknown edge_op_dtype '{op_dtype}'")
    n = tel.resolution
    pitch = tel.pixel_pitch
    dt = tel.sampling_time
    outer_idx, inner_idx = _ring_masks(n)
    A_l, B_l, steps, nsub = [], [], [], []
    for i in range(atm.n_layers):
        A, Bc = extension_operators(atm.layer(i), n, pitch, device=device)
        A_l.append(A)
        B_l.append(Bc)
        v, th = atm.wind_speeds[i], atm.wind_directions[i]
        sy = v * math.sin(th) * dt / pitch
        sx = v * math.cos(th) * dt / pitch
        steps.append((sy, sx))
        nsub.append((int(math.floor(abs(sy))) + 1 if sy != 0.0 else 0,
                     int(math.floor(abs(sx))) + 1 if sx != 0.0 else 0))

    def ops(mats):
        return torch.as_tensor(np.stack(mats), device=device).to(
            OP_DTYPES[op_dtype])
    model = EdgeFlowModel(
        A=ops(A_l), Bc=ops(B_l),
        outer_idx=torch.as_tensor(outer_idx, device=device),
        inner_idx=torch.as_tensor(inner_idx, device=device),
        step_px=tuple(steps), nsub=tuple(nsub), size=n)
    state = EdgeFlowState(phases=torch.as_tensor(
        _initial_phases([int(seed)], atm, n, pitch)[0], dtype=torch.float32,
        device=device))
    return model, state


def batch_states(seed, atm: AtmosphereConfig, tel: TelescopeConfig,
                 n_scenarios: int,
                 device: torch.device | str = "cuda") -> EdgeFlowState:
    """B independent initial screen sets, (B, L, n, n): per-scenario
    Monte-Carlo over turbulence realizations
    (montecarlo.run_batch(edge_state=...) without shared_turbulence),
    each from its own FFT-synthesized seed screens, as build() crops."""
    seeds = [int(seed) + 7919 * (b + 1) for b in range(n_scenarios)]
    return EdgeFlowState(phases=torch.as_tensor(
        _initial_phases(seeds, atm, tel.resolution, tel.pixel_pitch),
        dtype=torch.float32, device=device))


def schedule(model: EdgeFlowModel, idx):
    """The host shift schedule of step ``idx`` (a number, or a (B,) array
    of per-scenario step indices), in float32 as the JAX package's traced
    schedule: per layer, the whole-pixel shifts (ky, kx) (int arrays, the
    shape of ``idx``), their signs, and the fractional offsets (fy, fx)
    (float32 arrays) of the output sample."""
    idxf = np.asarray(idx, np.float32)
    one = np.float32(1.0)
    out = []
    for sy, sx in model.step_px:
        per_axis = []
        for s in (np.float32(sy), np.float32(sx)):
            o = (idxf + one) * s
            k = (np.floor(o) - np.floor(idxf * s)).astype(np.int64)
            per_axis.append((k, o - np.floor(o)))
        (ky, fy), (kx, fx) = per_axis
        out.append((ky, kx, (1 if sy > 0 else -1, 1 if sx > 0 else -1),
                    fy, fx))
    return out


def shift_rounds(sched) -> int:
    """The shift rounds a step of ``sched`` (schedule) takes: its largest
    whole-pixel shift; rounds past every layer's shift count never touch
    the state."""
    return max((int(np.abs(k).max()) for ky, kx, *_ in sched
                for k in (ky, kx)), default=0)


def _apply(op: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """op (L, m, k) applied to v (S, L, k) -> (S, L, m) float32.  A
    bfloat16 op takes bfloat16 v and accumulates in float32 (the JAX
    package's preferred_element_type): on the card by a bf16 product
    with float32 output, on the CPU on the float32 upcast of the bf16
    values (whose products float32 holds exactly)."""
    rhs = v.to(op.dtype).permute(1, 2, 0)                 # (L, k, S)
    if op.dtype == torch.float32:
        out = torch.bmm(op, rhs)
    elif op.is_cuda:
        out = torch.bmm(op, rhs, out_dtype=torch.float32)
    else:
        out = torch.bmm(op.float(), rhs.float())
    return out.permute(2, 0, 1)


def _draw_borders(model: EdgeFlowModel, phases: torch.Tensor,
                  eps: torch.Tensor) -> torch.Tensor:
    """X = A Z + B eps for every layer (telescopeAbstract.m:898-901):
    phases (S, L, n, n), eps (S, L, nX) -> borders (S, L, nX)."""
    S, L = phases.shape[:2]
    Z = phases.reshape(S, L, -1).index_select(-1, model.inner_idx)
    return (_apply(model.A, Z) + _apply(model.Bc, eps)).to(phases.dtype)


def _embed(model: EdgeFlowModel, phases: torch.Tensor,
           borders: torch.Tensor) -> torch.Tensor:
    """(S, L, n+2, n+2) frames: interior = phases, ring = borders (the
    mapShift fill, telescopeAbstract.m:899-901)."""
    S, L, n = phases.shape[:3]
    frames = phases.new_empty((S, L, n + 2, n + 2))
    frames[..., 1:-1, 1:-1] = phases
    frames.view(S, L, -1)[..., model.outer_idx] = borders
    return frames


def _select(candidates, keys: np.ndarray) -> torch.Tensor:
    """Per scenario s, row s of ``candidates(tuple(keys[s]))`` (an
    (S, ...) tensor; ``keys`` is an (S, 2) host int array): one
    candidate when the batch agrees, else a torch.where over the
    distinct keys."""
    if (keys == keys[0]).all():
        return candidates(tuple(keys[0]))
    out = None
    for key in {tuple(k) for k in keys}:
        pick = torch.as_tensor((keys == key).all(axis=1))
        c = candidates(key)
        pick = pick.to(c.device).view(-1, *([1] * (c.dim() - 1)))
        out = c if out is None else torch.where(pick, c, out)
    return out


def _shift(frame: torch.Tensor, n: int, dy: int, dx: int) -> torch.Tensor:
    """phase'(i, j) = frame[i+1-dy, j+1-dx] for integer dy, dx in
    {-1, 0, 1}: an exact translation that takes the border on the
    leading edge."""
    return frame[..., 1 - dy:1 - dy + n, 1 - dx:1 - dx + n]


def _sample(frame: torch.Tensor, n: int, fy: np.ndarray,
            fx: np.ndarray) -> torch.Tensor:
    """The bilinear sample of a (S, n+2, n+2) frame at offsets (fy, fx)
    in [0, 1) (S,): the window base is 1 where the offset is exactly 0,
    so the weights select the interior (JAX _shift_dynamic)."""
    one = np.float32(1.0)
    ry, rx = one - fy, one - fx
    iy = np.clip(np.floor(ry), 0, 1).astype(np.int64)
    ix = np.clip(np.floor(rx), 0, 1).astype(np.int64)
    wy, wx = ry - iy.astype(np.float32), rx - ix.astype(np.float32)
    w = _select(lambda k: frame[:, k[0]:k[0] + n + 1, k[1]:k[1] + n + 1],
                np.stack([iy, ix], axis=1))
    taps = ((one - wy) * (one - wx), (one - wy) * wx, wy * (one - wx),
            wy * wx)
    if (wy == wy[0]).all() and (wx == wx[0]).all():
        c = [float(t[0]) for t in taps]
    else:
        c = [torch.as_tensor(t, device=frame.device).view(-1, 1, 1)
             for t in taps]
    return (c[0] * w[:, :n, :n] + c[1] * w[:, :n, 1:] + c[2] * w[:, 1:, :n]
            + c[3] * w[:, 1:, 1:])


def advance(model: EdgeFlowModel, state: EdgeFlowState, idx,
            generator: torch.Generator | None = None,
            eps: torch.Tensor | None = None, rows: slice | None = None):
    """One control step of every layer; returns (state', pupil phase).

    ``idx`` is the absolute step index: a host number, or a (B,) array
    of per-scenario indices (then the state is (B, L, n, n)).  The
    stored screens move by floor(o) - floor(o_prev) exact pixel shifts
    (o = (idx+1) * step), each after a conditional-Gaussian border draw;
    the sub-pixel remainder frac(o) is applied only to the returned
    phase, the sum over layers (telescopeAbstract.m:446-447): (n, n) for
    an (L, n, n) state, else (B, n, n).

    Border noise is ``eps`` ((K_max+1, L, nX), or (B, K_max+1, L, nX)
    for a batched state: round s takes eps[..., s, :, :]) when given --
    the injected normals of the parity tests -- else drawn round by round
    from ``generator`` (on the state's device), (L, nX) a round for an
    (L, n, n) state and (B, L, nX) for a batched one.

    ``rows`` (a slice) says that the batched state holds those rows of a
    batch whose (B,) step indices ``idx`` are: the schedule and the
    drawn border noise are the whole batch's, and the rows kept, so a
    scenario's flow does not depend on the rows advanced beside it
    (closed_loop.simulate(rows=...)); ``eps`` is then the rows' own.
    """
    if eps is None and generator is None:
        raise ValueError("advance needs a generator or eps")
    n = model.size
    shared = state.phases.dim() == 3
    phases = state.phases[None] if shared else state.phases   # (S, L, n, n)
    S, L = phases.shape[:2]
    idx = np.atleast_1d(np.asarray(idx, np.float32))
    S_all = S if rows is None else idx.size
    keep = slice(None) if rows is None else rows
    if idx.size not in (1, S_all) or len(range(S_all)[keep]) != S:
        raise ValueError(f"{idx.size} step indices for {S} screen sets")
    sched = schedule(model, idx)
    K = model.k_max
    if eps is not None:
        eps = eps.to(phases.device)
        eps = (eps[None] if eps.dim() == 3 else eps).expand(S, *eps.shape[-3:])

    def noise(s):
        if eps is not None:
            return eps[:, s]
        return torch.randn((S_all, L, model.n_border), generator=generator,
                           device=phases.device, dtype=phases.dtype)[keep]

    rounds = shift_rounds(sched)
    if rows is not None:
        sched = [(ky[rows], kx[rows], sgn, fy[rows], fx[rows])
                 for ky, kx, sgn, fy, fx in sched]
    for s in range(rounds):
        frames = _embed(model, phases, _draw_borders(model, phases,
                                                     noise(s)))
        new = []
        for l, (ky, kx, (sgn_y, sgn_x), _, _) in enumerate(sched):
            d = np.stack([np.where(s < np.abs(ky), sgn_y, 0),
                          np.where(s < np.abs(kx), sgn_x, 0)], axis=1)
            d = np.broadcast_to(d, (S, 2))
            new.append(_select(lambda k, l=l: (
                phases[:, l] if k == (0, 0)
                else _shift(frames[:, l], n, *k)), d))
        phases = torch.stack(new, dim=1)

    # output-side fractional sampling (never written back)
    frames = _embed(model, phases, _draw_borders(model, phases, noise(K)))
    out = None
    for l, (_, _, _, fy, fx) in enumerate(sched):
        fy, fx = np.broadcast_to(fy, (S,)), np.broadcast_to(fx, (S,))
        layer = _sample(frames[:, l], n, fy, fx)
        out = layer if out is None else out + layer
    if shared:
        return EdgeFlowState(phases=phases[0]), out[0]
    return EdgeFlowState(phases=phases), out


def rollout(model: EdgeFlowModel, state: EdgeFlowState,
            generator: torch.Generator | None, n_steps: int,
            fit_full: torch.Tensor, mask: torch.Tensor,
            mask_npix: torch.Tensor, mag: float = 1.0,
            eps: torch.Tensor | None = None):
    """Open-loop pre-pass from step 0: evolve + piston-removed Zernike fit
    per step (the ID data generator, README.md:69-93, with this flow).
    ``eps`` ((n_steps, K_max+1, L, nX)) injects the border noise, else
    ``generator`` draws it.  Returns (final state, (n_steps, n_modes)
    coefficients, piston column included)."""
    out, chunk = [], []
    for idx in range(n_steps):
        state, raw = advance(model, state, idx, generator,
                             None if eps is None else eps[idx])
        chunk.append(zernike.piston_removed_phase_masked(
            raw, mask, mask_npix) * mag)
        if len(chunk) == zernike.ROLLOUT_CHUNK or idx == n_steps - 1:
            ph = torch.stack(chunk)
            out.append(ph.reshape(len(chunk), -1) @ fit_full.T)
            chunk = []
    return state, torch.cat(out)
