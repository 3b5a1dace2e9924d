"""PyTorch port vs the JAX package: the Toeplitz-block-Toeplitz operator
and the slopes-MMSE reconstructors (NGS, zonal tomography, LGS).

The same numpy-seeded inputs go through the JAX function and its port on
CPU tensors.  Tolerances: the host float64 kernel generators bit-equal
(the same numpy calls); TBT products rtol 1e-4 / atol 1e-4 (the JAX
tests' own); CG reconstructions 1e-4 of the map's RMS with the same
per-row iteration count wherever float32 rounding is not amplified --
fixed CG depths up to 4 iterations, and a well-conditioned batch (slope
noise 0.3 px) whose rows stop at different iterations, against
``jax.vmap`` of the JAX function row by row.

Deep float32 CG is not reproducible between two implementations: on the
wfs demo's problem (10x10 SH at R=80, noise 0.02 px) the JAX package's
own float32 iterate leaves the float64 CG iterate by 3e-5 of the RMS at
8 iterations and by 5-22% at 12-19, and the port's float32 iterate does
the same on another path (port against JAX: <= 1e-5 of the RMS through
4 iterations, 1e-4 at 5-6 on the tomographic operator).  There the port is held to the JAX tests'
criteria (tests/test_slopes_mmse.py: MMSE beats zonal LS under noise,
off-axis and lagged reconstruction beat the naive one, tomography beats
one guide star, the cone model beats the NGS model) and to a true
residual within the JAX stopping rule.  Sizes as in
tests/test_slopes_mmse.py (R=80, 10 lenslets).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_sensorlessao_tpu.models import slopes_mmse as jsm
from mpc_sensorlessao_tpu.models import wfs as jwfs
from mpc_sensorlessao_tpu.ops import phase_screens as jps
from mpc_sensorlessao_tpu.ops import phase_stats as jstats
from mpc_sensorlessao_tpu.ops import relay as jrelay
from mpc_sensorlessao_tpu.ops import toeplitz as jtbt
from mpc_sensorlessao_tpu.utils import config as jconfig
from mpc_sensorlessao_tpu_torch import interop
from mpc_sensorlessao_tpu_torch.models import slopes_mmse, wfs
from mpc_sensorlessao_tpu_torch.ops import phase_screens, phase_stats
from mpc_sensorlessao_tpu_torch.ops import relay, toeplitz
from mpc_sensorlessao_tpu_torch.utils import config

torch.backends.cuda.matmul.allow_tf32 = False
torch.set_num_threads(1)

ATM1 = dict(fractional_r0=(1.0,), altitudes=(0.0,), wind_speeds=(5.0,),
            wind_directions=(0.0,))
ATM_H = dict(fractional_r0=(1.0,), altitudes=(8000.0,), wind_speeds=(5.0,),
             wind_directions=(0.0,))
R, NL = 80, 10
PITCH = 1.0 / (R - 1)
ARCSEC = np.pi / 180 / 3600
TH = 10 * ARCSEC
GS = [(TH, 0.0), (-TH / 2, TH * 0.866), (-TH / 2, -TH * 0.866)]
WELL_SIGMA = 0.3         # slope noise [px] of the well-conditioned batch


def npy(t):
    return t.detach().cpu().numpy()


def t32(a):
    return torch.as_tensor(np.array(a, dtype=np.float32))


def rms_close(got, want, frac=1e-4):
    """Each map within frac of its own RMS (rows of a batch apart)."""
    got, want = np.asarray(got), np.asarray(want)
    for g, w in zip(got.reshape(len(want), -1), want.reshape(len(want), -1)):
        rms = float(np.sqrt(np.mean(w.astype(np.float64) ** 2)))
        np.testing.assert_allclose(g, w, rtol=0, atol=frac * max(rms, 1e-30))


# ------------------------------------------------------------- toeplitz

@pytest.fixture(scope="module")
def rect():
    gen = np.random.default_rng(0).normal(size=(4 + 3 - 1, 5 + 6 - 1))
    return (jtbt.build((4, 3), (5, 6), gen),
            toeplitz.build((4, 3), (5, 6), gen, "cpu"))


@pytest.mark.parametrize("case", ["full", "matvec", "batched", "transpose"])
def test_tbt_matches_jax(rect, case):
    jop, op = rect
    rng = np.random.default_rng(1)
    if case == "full":
        np.testing.assert_array_equal(toeplitz.full(op), jtbt.full(jop))
        assert op.compression == pytest.approx(jop.compression)
        assert op.shape == jop.shape
    elif case == "transpose":
        np.testing.assert_array_equal(toeplitz.full(toeplitz.transpose(op)),
                                      jtbt.full(jtbt.transpose(jop)))
    else:
        shape = (op.shape[1],) if case == "matvec" else (7, 2, op.shape[1])
        x = rng.normal(size=shape).astype(np.float32)
        want = np.asarray(jtbt.matvec(jop, jnp.asarray(x)))
        got = npy(toeplitz.matvec(op, t32(x)))
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(got, x @ toeplitz.full(op).T, rtol=1e-4,
                                   atol=1e-4)


def test_tbt_from_stationary_and_solve_match_jax():
    atm = config.AtmosphereConfig()
    jatm = jconfig.AtmosphereConfig()
    op = toeplitz.from_stationary(lambda r: phase_stats.covariance(r, atm),
                                  n=6, pitch=0.1, device="cpu")
    jop = jtbt.from_stationary(lambda r: jstats.covariance(r, jatm), n=6,
                               pitch=0.1)
    np.testing.assert_array_equal(toeplitz.full(op), jtbt.full(jop))
    b = np.random.default_rng(3).normal(size=op.shape[0])
    np.testing.assert_allclose(toeplitz.solve(op, b), jtbt.solve(jop, b),
                               rtol=1e-10)
    with pytest.raises(ValueError, match="generator shape"):
        toeplitz.build((4, 3), (5, 6), np.zeros((5, 5)), "cpu")
    assert interop.tbt_from_numpy(jop, "cpu").n_block == (6, 6)


# ----------------------------------------------------------- slopes-MMSE

@pytest.fixture(scope="module")
def sh():
    return jwfs.build(R, n_lenslet=NL), wfs.build(R, n_lenslet=NL,
                                                  device="cpu")


def screen_slopes(sh_, seeds, atm=ATM1, scale=0.3):
    """Geometric slopes [rad/px] of mean-removed numpy-seeded screens."""
    jatm = jconfig.AtmosphereConfig(**atm)
    out = []
    for s in seeds:
        scr = np.asarray(jps.synthesize_screen(s, jatm, R, PITCH))[:R, :R]
        scr = scr * scale
        out.append(np.asarray(jwfs.geometric_slopes(
            sh_, jnp.asarray(scr - scr.mean(), jnp.float32))))
    return np.stack(out).astype(np.float32)


def tomo_slopes(sh_, seeds, scale=0.3):
    """(len(seeds), 3, 2 n_valid) slopes [rad/px] of the three guide
    stars GS, each frame one numpy-seeded 8 km screen projected into the
    three directions (what the 3-GS system measures), through the JAX
    relay and SH."""
    jatm = jconfig.AtmosphereConfig(**ATM_H)
    out = []
    for s in seeds:
        scr = jnp.asarray(np.asarray(jps.synthesize_screen(
            s, jatm, 192, PITCH, oversample=1)) * scale, jnp.float32)
        out.append([np.asarray(jwfs.geometric_slopes(
            sh_, jrelay.project_layers([scr], [PITCH], 0.5, jatm.altitudes,
                                       R, direction=g))) for g in GS])
    return np.asarray(out, np.float32)


def _jax_cg_iters(matvec, b, tol, maxit):
    """The JAX package's _cg loop (slopes_mmse.py:192-214) returning its
    iteration count: the reference count under jax.vmap."""
    b2 = jnp.sum(b * b)

    def cond(st):
        return jnp.logical_and(st[4] < maxit, st[3] > tol ** 2 * b2)

    def body(st):
        x, r, p, rs, it = st
        Ap = matvec(p)
        alpha = rs / (jnp.sum(p * Ap) + 1e-30)
        r = r - alpha * Ap
        rs_new = jnp.sum(r * r)
        return (x + alpha * p, r, r + (rs_new / (rs + 1e-30)) * p, rs_new,
                it + 1)

    st = (jnp.zeros_like(b), b, b, b2, jnp.asarray(0))
    return jax.lax.while_loop(cond, body, st)[4]


def _jax_rhs(model, slopes, n_gs=None):
    """The right-hand side the JAX reconstructors form (scatter, /pitch)."""
    nl = model.n_lenslet
    sel = np.flatnonzero(np.asarray(model.valid).ravel())
    s = np.asarray(slopes, np.float32).reshape(-1, 2, sel.size) / PITCH
    full = np.zeros((s.shape[0], 2, nl * nl), np.float32)
    full[:, :, sel] = s
    return jnp.asarray(full.reshape(len(slopes), -1))


@functools.lru_cache(maxsize=None)
def _cached_pair(kind, noise_var, kw):
    jsh = jwfs.build(R, n_lenslet=NL)
    return _make_pair(kind, (jsh, wfs.build(R, n_lenslet=NL, device="cpu")),
                      noise_var, **dict(kw))


def _build_pair(kind, sh_pair, noise_var, **kw):
    """(JAX model, port model), built once per configuration."""
    return _cached_pair(kind, noise_var, tuple(sorted(kw.items())))


def _make_pair(kind, sh_pair, noise_var, **kw):
    jsh, psh = sh_pair
    if kind == "ngs":
        return (jsm.build(jconfig.AtmosphereConfig(**ATM1), 1.0, NL,
                          jsh.valid, noise_var, **kw),
                slopes_mmse.build(config.AtmosphereConfig(**ATM1), 1.0, NL,
                                  psh.valid, noise_var, device="cpu", **kw))
    if kind == "tomo":
        return (jsm.build_tomographic(jconfig.AtmosphereConfig(**ATM_H), 1.0,
                                      NL, jsh.valid, noise_var, GS),
                slopes_mmse.build_tomographic(
                    config.AtmosphereConfig(**ATM_H), 1.0, NL, psh.valid,
                    noise_var, GS, device="cpu"))
    return (jsm.build_lgs(jconfig.AtmosphereConfig(**ATM_H), 1.0, NL,
                          jsh.valid, noise_var, lgs_height=20e3),
            slopes_mmse.build_lgs(config.AtmosphereConfig(**ATM_H), 1.0, NL,
                                  psh.valid, noise_var, lgs_height=20e3,
                                  device="cpu"))


_RECON = {"ngs": (jsm.reconstruct, slopes_mmse.reconstruct, jsm._apply_cxx),
          "tomo": (jsm.reconstruct_tomographic,
                   slopes_mmse.reconstruct_tomographic, jsm._apply_cxx_tomo),
          "lgs": (jsm.reconstruct_lgs, slopes_mmse.reconstruct_lgs,
                  jsm._apply_cxx)}


def _tbt_list(model, cls):
    """Every ``cls`` operator of a model, in field order (nested tuples
    flattened)."""
    out = []

    def walk(v):
        if isinstance(v, cls):
            out.append(v)
        elif isinstance(v, tuple):
            for w in v:
                walk(w)
    for f in dataclasses.fields(model):
        walk(getattr(model, f.name))
    return out


@pytest.mark.parametrize("kind,kw", [
    ("ngs", {}), ("ngs", {"mmse_dir": (TH, -TH / 2)}),
    ("ngs", {"lag": 0.04, "mag": 1.5}), ("tomo", {}), ("lgs", {})],
    ids=["ngs", "ngs-offaxis", "ngs-lag-mag", "tomo", "lgs"])
def test_builds_match_jax(sh, kind, kw):
    """Host float64 kernels -> float32 generators: bit-equal, and the
    interop copy of the JAX model equals the port's build."""
    jm, pm = _build_pair(kind, sh, 1e-2, **kw)
    jops = _tbt_list(jm, jtbt.TBTOperator)
    pops = _tbt_list(pm, toeplitz.TBTOperator)
    assert len(jops) == len(pops) > 0
    for a, b in zip(jops, pops):
        assert (a.n_block, a.n_inner) == (b.n_block, b.n_inner)
        np.testing.assert_array_equal(npy(b.gen), np.asarray(a.gen))
    convert = {"ngs": interop.slopes_mmse_from_numpy,
               "tomo": interop.slopes_tomography_from_numpy,
               "lgs": interop.lgs_slopes_mmse_from_numpy}[kind]
    carried = convert(jax.tree.map(np.asarray, jm), "cpu")
    for a, b in zip(_tbt_list(carried, toeplitz.TBTOperator), pops):
        np.testing.assert_array_equal(npy(a.gen), npy(b.gen))
    assert carried.noise_var == pm.noise_var
    np.testing.assert_array_equal(npy(carried.sel), npy(pm.sel))
    if kind == "lgs":
        for a, b in zip(jm.interp, pm.interp):
            np.testing.assert_array_equal(npy(b), np.asarray(a))


@pytest.mark.parametrize("kind", ["ngs", "tomo", "lgs"])
def test_operator_apply_matches_jax(sh, kind):
    """(C_xx + sigma^2 I) v on a random batch, invalid rows included."""
    jm, pm = _build_pair(kind, sh, 2.5)
    n = pm.n_lenslet ** 2 * 2 * (pm.n_gs if kind == "tomo" else 1)
    v = np.random.default_rng(4).normal(size=(3, n)).astype(np.float32)
    want = np.asarray(jax.vmap(lambda x: _RECON[kind][2](jm, x))(
        jnp.asarray(v)))
    apply = (slopes_mmse._apply_cxx_tomo if kind == "tomo"
             else slopes_mmse._apply_cxx)
    got = npy(apply(pm, t32(v)))
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("kind", ["ngs", "tomo", "lgs"])
@pytest.mark.parametrize("depth", [1, 2, 4])
def test_fixed_depth_cg_matches_jax(sh, kind, depth):
    """tol=0, maxit=depth on the wfs demo's problem (noise 0.02 px): the
    scatter, the operator and every CG update agree with JAX at 1e-4 of
    the map's RMS while float32 rounding is not amplified."""
    jsh, _ = sh
    jm, pm = _build_pair(kind, sh, (0.02 / PITCH) ** 2)
    atm = ATM1 if kind == "ngs" else ATM_H
    if kind == "tomo":                     # (2 frames, 3 guide stars, n)
        sl = tomo_slopes(jsh, [7, 8])
    else:
        sl = screen_slopes(jsh, [7, 8], atm)
    jrec, prec, _ = _RECON[kind]
    want = np.asarray(jax.vmap(lambda s: jrec(
        jm, s, PITCH, tol=0.0, maxit=depth))(jnp.asarray(sl)))
    got = prec(pm, t32(sl), PITCH, tol=0.0, maxit=depth)
    it = slopes_mmse.solve(pm, t32(sl), PITCH, tol=0.0, maxit=depth)[1]
    assert npy(it).tolist() == [depth] * len(sl)
    rms_close(npy(got), want)


def _well_conditioned_batch(jsh, kind):
    """Rows that stop at different iterations: screens with growing
    noise, a constant slope field (a tilt, the same in every guide-star
    direction), a zero frame (0 iterations)."""
    atm = ATM1 if kind == "ngs" else ATM_H
    rng = np.random.default_rng(5)
    if kind == "tomo":
        sl = tomo_slopes(jsh, [11, 12, 13])
    else:
        sl = screen_slopes(jsh, [11, 12, 13], atm)
    noise = np.array([0.0, 0.3, 3.0], np.float32).reshape(
        (3,) + (1,) * (sl.ndim - 1))
    sl = sl + rng.normal(0.0, 1.0, sl.shape).astype(np.float32) * noise
    n = sl.shape[-1] // 2
    tilt = np.concatenate([np.full(n, 0.2), np.zeros(n)]).astype(np.float32)
    tilt = np.broadcast_to(tilt, sl.shape[1:])
    return np.concatenate([sl, tilt[None], np.zeros_like(tilt)[None]])


@pytest.mark.parametrize("kind", ["ngs", "tomo", "lgs"])
def test_batched_cg_equals_vmapped_jax_row_by_row(sh, kind):
    """A batch through the port's native batched CG equals jax.vmap of
    the JAX reconstructor row by row: the same iteration count per row
    (rows stop at different iterations; a stopped row stays frozen) and
    the map within 1e-4 of its RMS (slope noise 0.3 px: no rounding
    amplification)."""
    jsh, _ = sh
    jm, pm = _build_pair(kind, sh, (WELL_SIGMA / PITCH) ** 2)
    sl = _well_conditioned_batch(jsh, kind)
    jrec, prec, japply = _RECON[kind]
    want = np.asarray(jax.vmap(lambda s: jrec(jm, s, PITCH))(
        jnp.asarray(sl)))
    maxit = 150 if kind == "tomo" else 100
    want_it = np.asarray(jax.vmap(lambda b: _jax_cg_iters(
        lambda v: japply(jm, v), b, 5e-2, maxit))(_jax_rhs(pm, sl)))
    got = prec(pm, t32(sl), PITCH)
    it = slopes_mmse.solve(pm, t32(sl), PITCH, maxit=maxit)[1]
    assert npy(it).tolist() == want_it.tolist()
    assert len(set(want_it.tolist())) >= 3 and want_it[-1] == 0
    rms_close(npy(got), want)
    # one row alone equals its row of the batch (frozen rows do not move;
    # 1e-6: a one-row matmul takes another BLAS path)
    one = prec(pm, t32(sl[1]), PITCH)
    it1 = slopes_mmse.solve(pm, t32(sl[1:2]), PITCH, maxit=maxit)[1]
    assert int(it1) == int(it[1])
    rms_close(npy(one)[None], npy(got[1:2]), 1e-6)


def test_default_tolerance_cg_meets_the_jax_stopping_rule(sh):
    """The demo's problem at tol 5e-2: the port's answer satisfies the
    JAX stopping rule on its TRUE residual (recomputed in float64), and
    its map's RMS is within 5% of the JAX map's and its depth within 10%
    or 2 iterations (float32 CG is not reproducible deeper, module docstring:
    on these three frames the RMS differs by 1.2%, 3.4% and 0.7%)."""
    jsh, _ = sh
    nv = (0.02 / PITCH) ** 2
    jm, pm = _build_pair("ngs", sh, nv)
    sl = screen_slopes(jsh, [7, 8, 9])
    want = np.asarray(jax.vmap(lambda s: jsm.reconstruct(jm, s, PITCH))(
        jnp.asarray(sl)))
    want_it = np.asarray(jax.vmap(lambda b: _jax_cg_iters(
        lambda v: jsm._apply_cxx(jm, v), b, 5e-2, 100))(_jax_rhs(pm, sl)))
    got = slopes_mmse.reconstruct(pm, t32(sl), PITCH)
    y, it = slopes_mmse.solve(pm, t32(sl), PITCH)
    assert (np.abs(npy(it) - want_it) <= np.maximum(0.1 * want_it, 2)).all()
    np.testing.assert_allclose(npy(got).std(axis=(-2, -1)),
                               want.std(axis=(-2, -1)), rtol=0.05)
    rel = npy(slopes_mmse.relative_residual(pm, t32(sl), PITCH, y))
    # the same residual from the dense float64 operator
    c = npy(slopes_mmse._scatter(pm, t32(sl), PITCH)).astype(np.float64)
    A = np.stack([npy(slopes_mmse._apply_cxx(pm, e))
                  for e in torch.eye(c.shape[-1])]).astype(np.float64)
    dense = (np.linalg.norm(c - npy(y).astype(np.float64) @ A.T, axis=-1)
             / np.linalg.norm(c, axis=-1))
    np.testing.assert_allclose(rel, dense, rtol=1e-5)
    assert (rel <= 5e-2).all(), rel


def test_scatter_refuses_a_wrong_slope_count(sh):
    _, pm = _build_pair("ngs", sh, 1.0)
    with pytest.raises(ValueError, match="valid lenslets"):
        slopes_mmse.reconstruct(pm, torch.zeros(3, 10), PITCH)


# --------------------------- the JAX tests' criteria on the port alone

def _corner(R_=R, NL_=NL):
    sub = R_ // NL_
    idx = np.clip(np.arange(NL_ + 1) * sub, 0, R_ - 1)
    pm = (np.hypot(*np.meshgrid(np.arange(NL_ + 1) - NL_ / 2,
                                np.arange(NL_ + 1) - NL_ / 2))
          <= NL_ / 2 + 0.5).ravel()
    return idx, pm


def _err(est, truth, pm):
    e = est.ravel()[pm] - truth[pm]
    e = e - e.mean()
    return float(np.sqrt((e ** 2).mean()))


def _screens(seeds, atm, n=192):
    return torch.as_tensor(np.stack([phase_screens.synthesize_screen(
        s, config.AtmosphereConfig(**atm), n, PITCH, oversample=1)
        for s in seeds]))


def test_port_mmse_beats_zonal_ls_under_noise(sh):
    """tests/test_slopes_mmse.py's VERDICT criterion on the port: MMSE
    error < 0.5 x the zonal LS error and < 0.35 x the turbulence."""
    _, psh = sh
    idx, pm = _corner()
    sub = R // NL
    n_c = (NL + 1) ** 2
    yy, xx = np.meshgrid(np.arange(R), np.arange(R), indexing="ij")
    bumps = np.stack([(np.maximum(0, 1 - np.abs(yy - idx[c // (NL + 1)]) / sub)
                       * np.maximum(0, 1 - np.abs(xx - idx[c % (NL + 1)]) / sub))
                      for c in range(n_c)])
    D = npy(wfs.geometric_slopes(psh, t32(bumps))).T.astype(np.float64)
    Rls = np.linalg.pinv(D, rcond=1e-3)
    sigma = 0.05
    model = slopes_mmse.build(config.AtmosphereConfig(**ATM1), 1.0, NL,
                              psh.valid, (sigma / PITCH) ** 2, device="cpu")
    scr = np.stack([phase_screens.synthesize_screen(
        1000 + s, config.AtmosphereConfig(**ATM1), R, PITCH)[:R, :R]
        for s in range(8)]).astype(np.float64)
    scr -= scr.mean(axis=(-2, -1), keepdims=True)
    rng = np.random.default_rng(1)
    noisy = (npy(wfs.geometric_slopes(psh, t32(scr)))
             + rng.normal(0, sigma, (8, 2 * psh.n_valid)))
    phi = npy(slopes_mmse.reconstruct(model, t32(noisy), PITCH))
    e_m, e_l = [], []
    for k in range(8):
        truth = scr[k][np.ix_(idx, idx)].ravel()
        e_m.append(_err(phi[k], truth, pm))
        e_l.append(_err(Rls @ noisy[k], truth, pm))
    turb = scr[0][np.ix_(idx, idx)].ravel()[pm].std()
    assert np.mean(e_m) < 0.5 * np.mean(e_l)
    assert np.mean(e_m) < 0.35 * turb


@pytest.mark.parametrize("case", ["offaxis", "tomography", "lgs"])
def test_port_anisoplanatic_reconstructions_beat_naive(sh, case):
    """The JAX tests' criteria through the port's relay and
    reconstructors on one batch of screens: off-axis MMSE < 0.6 x the
    on-axis model's error, 3-GS tomography < 0.4 x the best single GS,
    the H=20 km cone model < 0.8 x the NGS model and < 0.4 x the
    turbulence."""
    _, psh = sh
    idx, pm = _corner()
    patm = config.AtmosphereConfig(**ATM_H)
    seeds = {"offaxis": range(400, 410), "tomography": range(700, 708),
             "lgs": range(500, 510)}[case]       # the JAX tests' screens
    scr = _screens(seeds, ATM_H)

    def see(direction=(0.0, 0.0), height=float("inf")):
        ph = relay.project_layers([scr], [PITCH], 0.5, patm.altitudes, R,
                                  direction=direction, source_height=height)
        return ph - ph.mean(dim=(-2, -1), keepdim=True)

    truth = npy(see())[:, idx][:, :, idx].reshape(len(scr), -1)
    if case == "offaxis":
        dth = (TH, 0.0)
        truth = npy(see(dth))[:, idx][:, :, idx].reshape(len(scr), -1)
        sl = wfs.geometric_slopes(psh, see())
        good = slopes_mmse.build(patm, 1.0, NL, psh.valid, 1e-6,
                                 mmse_dir=dth, device="cpu")
        naive = slopes_mmse.build(patm, 1.0, NL, psh.valid, 1e-6,
                                  device="cpu")
        a = slopes_mmse.reconstruct(good, sl, PITCH)
        b = slopes_mmse.reconstruct(naive, sl, PITCH)
        ratio = 0.6
    elif case == "tomography":
        sl = torch.stack([wfs.geometric_slopes(psh, see(g)) for g in GS],
                         dim=1)
        tomo = slopes_mmse.build_tomographic(patm, 1.0, NL, psh.valid, 1e-6,
                                             GS, device="cpu")
        one = slopes_mmse.build(patm, 1.0, NL, psh.valid, 1e-6,
                                mmse_dir=(-TH, 0.0), device="cpu")
        a = slopes_mmse.reconstruct_tomographic(tomo, sl, PITCH)
        b = slopes_mmse.reconstruct(one, sl[:, 0], PITCH)
        ratio = 0.4
    else:
        sl = wfs.geometric_slopes(psh, see(height=20e3))
        cone = slopes_mmse.build_lgs(patm, 1.0, NL, psh.valid, 1e-6,
                                     lgs_height=20e3, device="cpu")
        ngs = slopes_mmse.build(patm, 1.0, NL, psh.valid, 1e-6, device="cpu")
        a = slopes_mmse.reconstruct_lgs(cone, sl, PITCH)
        b = slopes_mmse.reconstruct(ngs, sl, PITCH)
        ratio = 0.8
    ea = np.mean([_err(x, t, pm) for x, t in zip(npy(a), truth)])
    eb = np.mean([_err(x, t, pm) for x, t in zip(npy(b), truth)])
    assert ea < ratio * eb, (ea, eb)
    if case == "lgs":
        turb = np.mean([t[pm].std() for t in truth])
        assert ea < 0.4 * turb


def test_port_lgs_at_infinite_height_is_the_ngs_reconstructor(sh):
    _, psh = sh
    atm = config.AtmosphereConfig(**ATM1)
    a_m = slopes_mmse.build(atm, 1.0, NL, psh.valid, 1e-2, device="cpu")
    b_m = slopes_mmse.build_lgs(atm, 1.0, NL, psh.valid, 1e-2,
                                lgs_height=float("inf"), device="cpu")
    s = t32(np.random.default_rng(3).normal(size=(2, 2 * psh.n_valid)))
    a = npy(slopes_mmse.reconstruct(a_m, s, PITCH))
    b = npy(slopes_mmse.reconstruct_lgs(b_m, s, PITCH))
    assert np.allclose(a, b, atol=1e-4 * max(1.0, np.abs(a).max()))


def test_port_prediction_lag_beats_zero_lag(sh):
    """lag > 0 (CoxLag): 8 frames ahead under frozen flow, < 0.5 x the
    zero-lag reconstructor's error."""
    _, psh = sh
    atm_w = config.AtmosphereConfig(fractional_r0=(1.0,), altitudes=(0.0,),
                                    wind_speeds=(8.0,),
                                    wind_directions=(0.3,))
    tel = config.TelescopeConfig(resolution=R)
    lag = 8 * tel.sampling_time
    pred = slopes_mmse.build(atm_w, 1.0, NL, psh.valid, 1e-6, lag=lag,
                             device="cpu")
    zero = slopes_mmse.build(atm_w, 1.0, NL, psh.valid, 1e-6, device="cpu")
    layers = phase_screens.make_layers(3, atm_w, tel, device="cpu")
    idx, pm = _corner()
    t = [float(k) for k in range(0, 320, 40)]
    now = torch.stack([phase_screens.phase_at(layers, s, R) for s in t])
    ahead = torch.stack([phase_screens.phase_at(layers, s + 8, R) for s in t])
    now = now - now.mean(dim=(-2, -1), keepdim=True)
    ahead = npy(ahead - ahead.mean(dim=(-2, -1), keepdim=True))
    truth = ahead[:, idx][:, :, idx].reshape(len(t), -1)
    sl = wfs.geometric_slopes(psh, now)
    e = {}
    for name, m in (("pred", pred), ("zero", zero)):
        rec = npy(slopes_mmse.reconstruct(m, sl, PITCH))
        e[name] = np.mean([_err(x, y, pm) for x, y in zip(rec, truth)])
    assert e["pred"] < 0.5 * e["zero"], e
