"""The port's conditional-Gaussian frozen flow (ops/edge_flow.py) vs the
JAX package's, and its place in the loop and the Monte-Carlo batch.

Deterministic parity feeds both engines the same border noise: the port
takes the normals the JAX flow draws from its key,
jax.random.normal(fold_in(fold_in(key, idx), s), (L, nX)) for round s of
step idx, as injected ``eps``/``edge_eps``.  Statistical checks hold the
port's own sampler to the Von Karman analytics as
tests/test_edge_flow.py holds the JAX one.  Tolerances, unless stated:
screens within 1e-5 of their RMS (float32 roundoff of the border
products, which the exact shifts carry on), coefficients within 1e-4 of
their scale, loops at the golden tolerances of
tests/test_golden_trajectory.py (residual RMS rtol 0.01, u atol 0.02
max|u|).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_sensorlessao_tpu.models import closed_loop as jcl
from mpc_sensorlessao_tpu.ops import edge_flow as jedge
from mpc_sensorlessao_tpu.ops import zernike as jzernike
from mpc_sensorlessao_tpu.utils import config as jconfig
from mpc_sensorlessao_tpu_torch import interop, reference_config
from mpc_sensorlessao_tpu_torch.models import closed_loop, estimator
from mpc_sensorlessao_tpu_torch.models import pipeline
from mpc_sensorlessao_tpu_torch.ops import edge_flow, phase_stats, zernike
from mpc_sensorlessao_tpu_torch.parallel import montecarlo
from mpc_sensorlessao_tpu_torch.utils import config
from torch_loop_support import (START, _assert_trajectory,  # noqa: F401
                                carried, jax_system)

R = 32
ATM1 = dict(fractional_r0=(1.0,), altitudes=(0.0,), wind_speeds=(8.0,),
            wind_directions=(0.0,), flow="conditional")
# whole-pixel and half-pixel winds (0.5, 1.0 and -0.5 px a step at R=32:
# v dt / pitch is exactly those values), so the fractional offset is
# exactly 0 on some steps
V_HALF = 0.5 * (1.0 / (R - 1)) / (1.0 / 200.0)
ATM_INTEGER = dict(fractional_r0=(0.5, 0.3, 0.2),
                   altitudes=(0.0, 4000.0, 8000.0),
                   wind_speeds=(V_HALF, 2 * V_HALF, -V_HALF),
                   wind_directions=(0.0, 0.0, 0.0), flow="conditional")
WINDS = {
    "reference": None,                   # reference_config's 3 layers
    "slow": dict(ATM1, wind_speeds=(1.0,)),   # 0.155 px a step
    "integer": ATM_INTEGER,
}


def _atm(winds, module=config):
    if winds is None:
        return dataclasses.replace(
            module.reference_config(resolution=R).atmosphere,
            flow="conditional")
    return module.AtmosphereConfig(**winds)


def _tel(module=config, resolution=R):
    return module.TelescopeConfig(resolution=resolution)


def _normals(key, idxs, model):
    """The normals the JAX flow draws at steps ``idxs``:
    (len(idxs), K_max+1, L, nX) float32."""
    L, nX = model.Bc.shape[0], model.Bc.shape[-1]
    K = max(max(ns) for ns in model.nsub)

    @jax.jit
    def draw(idx):
        k = jax.random.fold_in(key, idx)
        return jnp.stack([jax.random.normal(jax.random.fold_in(k, s),
                                            (L, nX), dtype=jnp.float32)
                          for s in range(K + 1)])
    return np.stack([np.asarray(draw(int(i))) for i in idxs])


def _carry(jmodel, jstate):
    return (interop.edge_model_from_numpy(jax.tree.map(np.asarray, jmodel),
                                          "cpu"),
            interop.edge_state_from_numpy(jax.tree.map(np.asarray, jstate),
                                          "cpu"))


def _jax_advance(jmodel, jstate, key, idxs):
    @jax.jit
    def run(st):
        return jax.lax.scan(
            lambda st, idx: jedge.advance(jmodel, st, idx, key), st,
            jnp.asarray(idxs))
    final, out = run(jstate)
    return np.asarray(final.phases), np.asarray(out)


def _port_advance(model, state, idxs, eps):
    outs = []
    for t, idx in enumerate(idxs):
        state, out = edge_flow.advance(model, state, idx,
                                       eps=torch.as_tensor(eps[t]))
        outs.append(out.numpy())
    return state.phases.numpy(), np.stack(outs)


def _screen_close(got, want):
    scale = float(np.sqrt(np.mean(np.square(want))))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * scale)


def test_extension_operators_match_jax():
    """A and Bc at n=16 (3 inner-ring and border sizes of the reference
    frame) from the port's float64 torch covariance vs the JAX package's
    numpy one: within 1e-9 of their scale (the two covariance
    evaluations differ by ~1e-16 relative, and the conditioning of
    Cov(Z,Z), ~1e6 here, amplifies that), and the same ring order."""
    n, pitch = 16, 1 / 15
    A, Bc = edge_flow.extension_operators(config.AtmosphereConfig(**ATM1),
                                          n, pitch, device="cpu")
    jA, jBc = jedge.extension_operators(jconfig.AtmosphereConfig(**ATM1), n,
                                        pitch)
    for got, want in ((A, jA), (Bc, jBc)):
        np.testing.assert_allclose(got, want, rtol=1e-9,
                                   atol=1e-9 * np.abs(want).max())
    for got, want in zip(edge_flow._ring_masks(n), jedge._ring_masks(n)):
        np.testing.assert_array_equal(got, want)


def _frame_points(n, pitch):
    outer_idx, inner_idx = edge_flow._ring_masks(n)
    u = np.arange(n + 2) * pitch
    cc, rr = np.meshgrid(u, u, indexing="xy")
    pts_frame = (cc + 1j * rr).ravel()
    pts_phase = pts_frame.reshape(n + 2, n + 2)[1:-1, 1:-1].ravel()
    return pts_phase[inner_idx], pts_frame[outer_idx]


def test_extension_operators_consistent():
    """A = Cov(X,Z) Cov(Z,Z)^-1 and Bc Bc' = Cov(X|Z)
    (telescopeAbstract.m:863-884), as tests/test_edge_flow.py holds the
    JAX operators."""
    n, pitch = 16, 1 / 15
    atm = config.AtmosphereConfig(**ATM1)
    A, Bc = edge_flow.extension_operators(atm, n, pitch, device="cpu")
    Zp, Xp = _frame_points(n, pitch)
    assert A.shape == (len(Xp), len(Zp))
    ZZt = phase_stats.covariance_matrix(Zp, Zp, atm)
    ZXt = phase_stats.covariance_matrix(Zp, Xp, atm)
    XXt = phase_stats.covariance_matrix(Xp, Xp, atm)
    np.testing.assert_allclose(A @ ZZt, ZXt.T, rtol=1e-6, atol=1e-8)
    cond = XXt - A @ ZXt
    np.testing.assert_allclose(Bc @ Bc.T, cond, atol=1e-6)
    assert np.all(np.diag(cond) < np.diag(XXt))
    assert np.all(np.diag(cond) >= -1e-9)


def test_conditional_sampling_joint_covariance():
    """X = A Z + B eps with exact Z draws reproduces the analytic
    Cov(X, Z) empirically (within 15% of its scale over 3000 draws, as
    tests/test_edge_flow.py)."""
    n, pitch = 12, 1 / 11
    atm = config.AtmosphereConfig(**ATM1)
    A, Bc = edge_flow.extension_operators(atm, n, pitch, device="cpu")
    Zp, Xp = _frame_points(n, pitch)
    ZZt = phase_stats.covariance_matrix(Zp, Zp, atm)
    ZXt = phase_stats.covariance_matrix(Zp, Xp, atm)
    rng = np.random.default_rng(0)
    Lz = np.linalg.cholesky(ZZt + 1e-10 * np.eye(len(Zp)))
    ns = 3000
    Z = Lz @ rng.standard_normal((len(Zp), ns))
    X = A @ Z + Bc @ rng.standard_normal((Bc.shape[1], ns))
    emp_XZ = X @ Z.T / ns
    assert np.abs(emp_XZ - ZXt.T).max() / np.abs(ZXt).max() < 0.15


@pytest.mark.parametrize("op_dtype", ["float32", "bfloat16"])
def test_build_matches_jax(op_dtype):
    """edge_flow.build at R=32 with the reference atmosphere: the initial
    screens bit-equal the JAX package's (the same numpy seeds), the
    schedule constants equal, A and Bc within float32 (bf16: one bf16
    ulp) of the JAX operators; batch_states bit-equal too."""
    model, state = edge_flow.build(3, _atm(None), _tel(), op_dtype=op_dtype,
                                   device="cpu")
    jmodel, jstate = jedge.build(3, _atm(None, jconfig), _tel(jconfig),
                                 op_dtype=jnp.dtype(op_dtype))
    np.testing.assert_array_equal(state.phases.numpy(),
                                  np.asarray(jstate.phases))
    assert model.step_px == jmodel.step_px and model.nsub == jmodel.nsub
    assert model.k_max == 2 and model.A.dtype == edge_flow.OP_DTYPES[op_dtype]
    ulp = 2.0 ** -23 if op_dtype == "float32" else 2.0 ** -8
    for name in ("A", "Bc"):
        want = np.asarray(getattr(jmodel, name), np.float32)
        got = getattr(model, name).float().numpy()
        np.testing.assert_allclose(got, want, rtol=ulp,
                                   atol=ulp * np.abs(want).max())
    states = edge_flow.batch_states(5, _atm(None), _tel(), 2, device="cpu")
    jstates = jedge.batch_states(5, _atm(None, jconfig), _tel(jconfig), 2)
    assert states.phases.shape == (2, 3, R, R)
    np.testing.assert_array_equal(states.phases.numpy(),
                                  np.asarray(jstates.phases))


@pytest.mark.parametrize("winds", list(WINDS))
def test_advance_matches_jax(winds):
    """24 steps from step 350 on the JAX normals vs the JAX vectorized
    advance: the reference winds (layer 3 blows at 5 pi/3, so its row
    shifts are negative; two shift rounds), a sub-pixel wind (0.155 px a
    step, a whole-pixel shift every few steps) and whole- and half-pixel
    winds whose fractional offset is exactly 0 on some steps (the
    sample's window then selects the interior)."""
    jmodel, jstate = jedge.build(4, _atm(WINDS[winds], jconfig),
                                 _tel(jconfig))
    model, state = _carry(jmodel, jstate)
    if winds == "integer":
        sched = edge_flow.schedule(model, np.arange(350, 374))
        assert (sched[0][4] == 0).any() and (sched[1][4] == 0).all()
        assert (sched[2][1] < 0).any()
    key = jax.random.PRNGKey(11)
    idxs = np.arange(350, 374)
    want_final, want = _jax_advance(jmodel, jstate, key, idxs)
    got_final, got = _port_advance(model, state, idxs,
                                   _normals(key, idxs, jmodel))
    assert got.shape == (24, R, R)
    _screen_close(got, want)
    _screen_close(got_final, want_final)


def test_advance_distinct_start_steps_match_jax():
    """A (B, L, n, n) state at three distinct step indices (per-scenario
    shift schedules and fractional weights, including steps whose shift
    counts differ) vs the JAX advance of each scenario with its own
    key, 8 steps."""
    jmodel, _ = jedge.build(4, _atm(None, jconfig), _tel(jconfig))
    jstates = jedge.batch_states(6, _atm(None, jconfig), _tel(jconfig), 3)
    model, states = _carry(jmodel, jstates)
    starts = np.array([350, 357, 362])
    keys = [jax.random.PRNGKey(20 + b) for b in range(3)]
    want, want_final, eps = [], [], []
    for b in range(3):
        idxs = starts[b] + np.arange(8)
        f, o = _jax_advance(jmodel, jedge.EdgeFlowState(
            phases=jstates.phases[b]), keys[b], idxs)
        want.append(o)
        want_final.append(f)
        eps.append(_normals(keys[b], idxs, jmodel))
    eps = np.stack(eps, axis=1)                  # (T, B, K+1, L, nX)
    sched = [edge_flow.schedule(model, starts + t) for t in range(8)]
    assert any(len(set(s[2][0])) > 1 for s in sched)
    got_final, got = _port_advance(model, states,
                                   [starts + t for t in range(8)], eps)
    _screen_close(got, np.stack(want, axis=1))
    _screen_close(got_final, np.stack(want_final))


def test_advance_draws_only_rounds_that_shift():
    """Without eps, advance draws each round that shifts a layer, then
    the output round: the same screens as the eps path fed those draws at
    their round indices (rounds past every layer's shift count and the
    unused eps rows never matter)."""
    model, state = edge_flow.build(2, _atm(WINDS["slow"]), _tel(),
                                   device="cpu")
    gen = torch.Generator().manual_seed(3)
    replay = torch.Generator().manual_seed(3)
    st_gen, st_eps = state, state
    for idx in range(12):
        st_gen, out_gen = edge_flow.advance(model, st_gen, idx, gen)
        k = int(np.abs(edge_flow.schedule(model, idx)[0][1]).max())
        eps = torch.full((model.k_max + 1, 1, model.n_border), float("nan"))
        for s in list(range(k)) + [model.k_max]:
            eps[s] = torch.randn((1, model.n_border), generator=replay)
        st_eps, out_eps = edge_flow.advance(model, st_eps, idx, eps=eps)
        torch.testing.assert_close(out_gen, out_eps, rtol=0, atol=0)
    torch.testing.assert_close(st_gen.phases, st_eps.phases, rtol=0, atol=0)


def test_bf16_advance_matches_jax_and_its_float32_upcast():
    """edge_op_dtype="bfloat16": A and Bc stored in bf16, Z and eps
    rounded to bf16, products accumulated in float32.  Against the JAX
    bf16 advance on the same normals (24 steps): within 1e-5 of the
    screen RMS.  Against the float32 draw on the bf16 operators' float32
    upcast, from the same phases and normals: the draws differ only by
    the bf16 rounding of Z and eps, at most 2^-9 (|A| |Z| + |Bc| |eps|)
    per border pixel (plus 1e-6 of float32 accumulation), and do
    differ."""
    jmodel, jstate = jedge.build(4, _atm(None, jconfig), _tel(jconfig),
                                 op_dtype=jnp.bfloat16)
    model, state = _carry(jmodel, jstate)
    assert model.A.dtype == torch.bfloat16
    key = jax.random.PRNGKey(12)
    idxs = np.arange(350, 374)
    eps = _normals(key, idxs, jmodel)
    want_final, want = _jax_advance(jmodel, jstate, key, idxs)
    got_final, got = _port_advance(model, state, idxs, eps)
    _screen_close(got, want)
    _screen_close(got_final, want_final)

    A, Bc = model.A.float(), model.Bc.float()
    up = dataclasses.replace(model, A=A, Bc=Bc)
    phases = torch.as_tensor(got_final)[None]
    e = torch.as_tensor(eps[0, 0])[None]
    bf16 = edge_flow._draw_borders(model, phases, e)[0]
    f32 = edge_flow._draw_borders(up, phases, e)[0]
    Z = phases[0].reshape(model.n_layers, -1)[:, model.inner_idx]
    bound = 2.0 ** -9 * (torch.einsum("lxz,lz->lx", A.abs(), Z.abs())
                         + torch.einsum("lxy,ly->lx", Bc.abs(), e[0].abs()))
    assert ((bf16 - f32).abs() <= bound + 1e-6).all()
    assert (bf16 - f32).abs().max() > 0


def test_rollout_matches_jax():
    """The open-loop pre-pass (advance + piston-removed Zernike fit) over
    60 steps from step 0 on the JAX normals vs JAX edge_flow.rollout:
    coefficients within 1e-4 of their scale, and the final screens
    within 1e-4 of their RMS (the float32 drift of the border products
    grows with the step count: ~1.5e-5 of the RMS after 60 steps)."""
    jmodel, jstate = jedge.build(0, _atm(None, jconfig), _tel(jconfig))
    model, state = _carry(jmodel, jstate)
    jbasis = jzernike.make_basis(4, R)
    basis = zernike.make_basis(4, R, device="cpu")
    fit = basis.fit_full.numpy()
    np.testing.assert_allclose(fit, np.asarray(jbasis.fit_full), rtol=0,
                               atol=1e-6 * np.abs(fit).max())
    npix = float(np.asarray(jbasis.mask).sum())
    key = jax.random.PRNGKey(0)
    jfinal, jcoeffs = jedge.rollout(jmodel, jstate, key, 60, jbasis.fit_full,
                                    jbasis.mask, jnp.float32(npix), mag=1.3)
    eps = torch.as_tensor(_normals(key, np.arange(60), jmodel))
    final, coeffs = edge_flow.rollout(
        model, state, None, 60, torch.as_tensor(np.array(jbasis.fit_full)),
        torch.as_tensor(np.array(jbasis.mask)), torch.tensor(npix),
        mag=1.3, eps=eps)
    want = np.asarray(jcoeffs)
    assert coeffs.shape == want.shape == (60, 15)
    np.testing.assert_allclose(coeffs.numpy(), want, rtol=0,
                               atol=1e-4 * np.abs(want).max())
    want = np.asarray(jfinal.phases)
    np.testing.assert_allclose(final.phases.numpy(), want, rtol=0,
                               atol=1e-4 * np.sqrt(np.mean(want ** 2)))


@pytest.fixture(scope="module")
def jax_edge(jax_system):
    """The JAX conditional flow at R=64 (the loop's resolution)."""
    cfg, _ = jax_system
    tel = dataclasses.replace(cfg.telescope, resolution=cfg.resolution)
    atm = dataclasses.replace(cfg.atmosphere, flow="conditional")
    return jedge.build(int(cfg.sim.seed), atm, tel)


@pytest.mark.parametrize("noisy", [False, True])
def test_simulate_matches_jax_with_carried_operators(jax_system, carried,
                                                     jax_edge, noisy):
    """The port's loop on the JAX operators and the JAX conditional flow
    at R=64 (carried across by interop), 10 steps from the test split,
    same injected measurement noise and the JAX flow's border normals
    as edge_eps, vs JAX simulate(edge_model, edge_state, turb_key):
    golden tolerances."""
    cfg, jsys = jax_system
    loop, _ = carried
    jmodel, jstate = jax_edge
    model, state = _carry(jmodel, jstate)
    n_steps, p = 10, loop.est.n_pixels
    noise = np.zeros((n_steps, p), np.float32)
    if noisy:
        noise = (float(loop.est.noise_std) * np.random.default_rng(7)
                 .standard_normal((n_steps, p))).astype(np.float32)
    tkey = jax.random.PRNGKey(77)
    ref = jcl.simulate(jsys.loop, jsys.layers, cfg, jax.random.PRNGKey(9),
                       n_steps=n_steps, start_step=START, noise_scale=1.0,
                       edge_model=jmodel, edge_state=jstate,
                       noise_seq=jnp.asarray(noise), turb_key=tkey)
    eps = _normals(tkey, START + np.arange(n_steps), jmodel)
    pcfg = reference_config(resolution=64)
    out = closed_loop.simulate(loop, None, pcfg, None, n_steps=n_steps,
                               start_step=START,
                               noise_seq=torch.as_tensor(noise),
                               edge_model=model, edge_state=state,
                               edge_eps=torch.as_tensor(eps))
    assert out.u.shape == (n_steps, loop.influence.shape[1])
    for field in out:
        assert torch.isfinite(field).all()
    _assert_trajectory(out.u.numpy(), out.rms_res.numpy(),
                       np.asarray(ref.u), np.asarray(ref.rms_res))
    np.testing.assert_allclose(out.rms_turb.numpy(),
                               np.asarray(ref.rms_turb), rtol=1e-4)


def _evolve(seed, n_steps, atm=None):
    model, state = edge_flow.build(
        seed, atm or config.AtmosphereConfig(**ATM1), _tel(), device="cpu")
    gen = torch.Generator().manual_seed(seed)
    outs = []
    for idx in range(n_steps):
        state, out = edge_flow.advance(model, state, idx, gen)
        outs.append(out.numpy())
    return model, np.stack(outs)


def test_screen_translates_with_wind():
    """Frozen flow: the content moves ~round(sx) px a step along +x, and
    the overlap of consecutive steps stays correlated (> 0.98)."""
    model, phases = _evolve(3, 12)
    sy, sx = model.step_px[0]
    assert sy == 0.0 and sx > 1.0
    d = int(round(sx))
    cc = np.corrcoef(phases[6][:, d:].ravel(), phases[5][:, :-d].ravel())
    assert cc[0, 1] > 0.98, cc


def test_evolved_screen_statistics():
    """After 40 steps (screens regenerated through the border) the
    structure function of the port's own draws follows the Von Karman
    analytics within 45% at 3 and 8 px (tests/test_edge_flow.py's
    criterion, 6 seeds x 8 screens)."""
    scr = np.concatenate([_evolve(seed, 40)[1][-8:] for seed in range(6)])
    atm = config.AtmosphereConfig(**ATM1)
    pitch = _tel().pixel_pitch
    for sep in (3, 8):
        d_emp = np.mean((scr[:, :, sep:] - scr[:, :, :-sep]) ** 2)
        d_th = phase_stats.structure_function(sep * pitch, atm, np)
        assert abs(d_emp - d_th) / d_th < 0.45, (sep, d_emp, d_th)


def _edge_cfg(resolution=64, **atm):
    cfg = reference_config(resolution=resolution)
    return cfg.replace(
        atmosphere=dataclasses.replace(cfg.atmosphere, flow="conditional",
                                       **atm),
        sim=dataclasses.replace(cfg.sim, n_train=300, n_valid=50, n_test=20))


@pytest.fixture(scope="module")
def edge_system():
    cfg = _edge_cfg()
    return cfg, pipeline.build(cfg, "cpu")


def test_pipeline_build_and_closed_loop(edge_system):
    """pipeline.build with flow="conditional": no periodic layers, the
    edge state after the n_train + n_valid rollout (the rollout replayed
    from the initial screens with the build's generator), a finite
    coefficient series; run_closed_loop locks on the fresh flow (settled
    residual below 0.5x the turbulence over the last 10 of 20 steps)."""
    cfg, sys_ = edge_system
    assert sys_.layers is None and sys_.edge_model.size == 64
    assert sys_.coeff_series.shape == (350, sys_.basis.fit_full.shape[0])
    assert torch.isfinite(sys_.coeff_series).all()
    model, state0 = edge_flow.build(int(cfg.sim.seed), cfg.atmosphere,
                                    _tel(resolution=64), device="cpu")
    gen = torch.Generator().manual_seed(int(cfg.sim.seed))
    mask_npix = torch.tensor(float(sys_.basis.mask.sum()))
    final, coeffs = edge_flow.rollout(model, state0, gen, 350,
                                      sys_.basis.fit_full, sys_.basis.mask,
                                      mask_npix, mag=cfg.sim.magnification)
    torch.testing.assert_close(final.phases, sys_.edge_state.phases,
                               rtol=0, atol=0)
    torch.testing.assert_close(coeffs, sys_.coeff_series, rtol=0, atol=0)
    out = pipeline.run_closed_loop(sys_, cfg,
                                   torch.Generator().manual_seed(1))
    assert torch.isfinite(out.rms_res).all()
    assert (float(out.rms_res[-10:].mean())
            < 0.5 * float(out.rms_turb[-10:].mean()))


def test_pipeline_build_rejects_an_unknown_flow():
    cfg = _edge_cfg(resolution=16)
    cfg = cfg.replace(atmosphere=dataclasses.replace(cfg.atmosphere,
                                                     flow="wrapped"))
    with pytest.raises(ValueError, match="unknown atmosphere.flow"):
        pipeline.build(cfg, "cpu")


def _noise_draws(loop, seed, B, n_steps):
    """The noise run_batch's generator draws, (B, n_steps, pixels)."""
    gen = torch.Generator().manual_seed(seed)
    return torch.stack([estimator.sample_noise(loop.est, gen, (B,))
                        for _ in range(n_steps)], dim=1)


def test_run_batch_shared_turbulence_matches_single(edge_system):
    """run_batch(shared_turbulence=True) over B=3 scenarios (distinct D/r0
    and SNR) advances ONE flow and equals each scenario's own simulate
    from the same unbatched state with a generator of the same seed and
    the batch's noise draws replayed (float32 roundoff of the batched
    products only); a batched state or distinct start steps are
    refused."""
    cfg, sys_ = edge_system
    scen = montecarlo.make_scenarios(
        cfg, torch.Generator().manual_seed(4), 3, d_over_r0_grid=(5.0, 8.0),
        snr_db_grid=(10.0, 20.0), device="cpu")
    out = montecarlo.run_batch(
        sys_.loop, None, cfg, scen, 8, edge_model=sys_.edge_model,
        edge_state=sys_.edge_state, shared_turbulence=True,
        turb_generator=torch.Generator().manual_seed(77))
    draws = _noise_draws(sys_.loop, scen.noise_seed, 3, 8)
    for i in range(3):
        one = closed_loop.simulate(
            sys_.loop, None, cfg, None, 8, start_step=START,
            mag=float(scen.mag[i]), noise_scale=float(scen.noise_scale[i]),
            noise_seq=draws[i], edge_model=sys_.edge_model,
            edge_state=sys_.edge_state,
            turb_generator=torch.Generator().manual_seed(77))
        torch.testing.assert_close(out.rms_res[i], one.rms_res, rtol=1e-4,
                                   atol=1e-5)
        torch.testing.assert_close(out.u[i], one.u, rtol=1e-3, atol=1e-4)
    # one realization: the unit turbulence is the same in every scenario
    unit = out.rms_turb / scen.mag[:, None]
    torch.testing.assert_close(unit[1:], unit[:1].expand(2, -1))
    states = edge_flow.batch_states(1, cfg.atmosphere, _tel(resolution=64), 3,
                                    device="cpu")
    with pytest.raises(ValueError, match="unbatched"):
        montecarlo.run_batch(sys_.loop, None, cfg, scen, 2,
                             edge_model=sys_.edge_model, edge_state=states,
                             shared_turbulence=True)
    moved = scen._replace(start_step=scen.start_step + torch.arange(3.0))
    with pytest.raises(ValueError, match="distinct start_steps"):
        montecarlo.run_batch(sys_.loop, None, cfg, moved, 2,
                             edge_model=sys_.edge_model,
                             edge_state=sys_.edge_state,
                             shared_turbulence=True)


def test_run_batch_per_scenario_turbulence_decorrelates(edge_system):
    """Per-scenario turbulence from batch_states: B=3 distinct, finite
    realizations (the uncorrected turbulence differs between scenarios),
    each controlled (settled residual below the turbulence on every
    realization, 20 steps)."""
    cfg, sys_ = edge_system
    B = 3
    states = edge_flow.batch_states(123, cfg.atmosphere, _tel(resolution=64),
                                    B, device="cpu")
    scen = montecarlo.make_scenarios(cfg, torch.Generator().manual_seed(1), B,
                                     device="cpu")
    out = montecarlo.run_batch(sys_.loop, None, cfg, scen, 20,
                               edge_model=sys_.edge_model, edge_state=states)
    turb, res = out.rms_turb.numpy(), out.rms_res.numpy()
    assert np.isfinite(res).all()
    assert np.abs(turb[0] - turb[1]).max() > 1e-3
    assert np.abs(turb[1] - turb[2]).max() > 1e-3
    assert (res[:, -10:].mean(axis=1) < turb[:, -10:].mean(axis=1)).all()


def test_run_batch_per_scenario_distinct_starts_match_single(edge_system):
    """Per-scenario turbulence from ONE unbatched state at distinct start
    steps (per-scenario schedules) with injected border noise equals
    each scenario's single simulate at its own start (float32 roundoff
    only): the masks and weights of the batched advance pick each
    scenario's own shifts."""
    cfg, sys_ = edge_system
    model = sys_.edge_model
    starts = torch.tensor([350.0, 353.0, 361.0])
    rng = np.random.default_rng(8)
    eps = torch.as_tensor(rng.standard_normal(
        (3, 6, model.k_max + 1, model.n_layers, model.n_border)
    ).astype(np.float32))
    noise = torch.as_tensor((float(sys_.est.noise_std) * rng.standard_normal(
        (3, 6, sys_.est.n_pixels))).astype(np.float32))
    both = closed_loop.simulate(sys_.loop, None, cfg, None, 6,
                                start_step=starts, noise_seq=noise,
                                edge_model=model, edge_state=sys_.edge_state,
                                edge_eps=eps)
    scale = float(both.u.abs().max())
    for i in range(3):
        one = closed_loop.simulate(
            sys_.loop, None, cfg, None, 6, start_step=float(starts[i]),
            noise_seq=noise[i], edge_model=model,
            edge_state=sys_.edge_state, edge_eps=eps[i])
        torch.testing.assert_close(both.u[i], one.u, rtol=0,
                                   atol=1e-4 * scale)
        torch.testing.assert_close(both.rms_res[i], one.rms_res, rtol=1e-4,
                                   atol=1e-6)
    assert not torch.allclose(both.rms_turb[0], both.rms_turb[1])


def test_bf16_build_runs_the_loop():
    """pipeline.build with edge_op_dtype="bfloat16" at R=32: bf16
    operators, a finite loop through run_batch (per-scenario
    turbulence, 4 steps)."""
    cfg = _edge_cfg(resolution=32, edge_op_dtype="bfloat16")
    cfg = cfg.replace(sim=dataclasses.replace(cfg.sim, n_train=120,
                                              n_valid=20))
    sys_ = pipeline.build(cfg, "cpu")
    assert sys_.edge_model.A.dtype == torch.bfloat16
    scen = montecarlo.make_scenarios(cfg, torch.Generator().manual_seed(1), 2,
                                     device="cpu")
    out = montecarlo.run_batch(sys_.loop, None, cfg, scen, 4,
                               edge_model=sys_.edge_model,
                               edge_state=sys_.edge_state)
    for field in out:
        assert torch.isfinite(field).all()
    with pytest.raises(ValueError, match="edge_op_dtype"):
        edge_flow.build(0, cfg.atmosphere, _tel(), op_dtype="float16",
                        device="cpu")
