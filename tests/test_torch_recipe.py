"""The port's strong-turbulence recipe vs the JAX package's (ROADMAP A.7).

The recipe (README.md:128-143; benchmarks/montecarlo_sweep.py:60-67):
radial order 10 (65 states), the MMSE estimator with the analytic Von
Karman prior scaled by prior_scale = min(0.15, 0.5/(D/r0)), the warm
start, var_ridge 1e-2 and r_weight 30; and the loop options that run
with it -- estimator-VAR fusion (est_gain, innovation_gate) and the
tracking Gauss-Newton estimator (track_gn_iters).

The same numpy-seeded inputs go through the JAX function and the port's.
Loops run at R=64, the rest at R=32.  As in tests/test_torch_loop.py the
JAX operators are carried across with ``interop`` to hold the control
step apart from the build; the trajectory tolerances are those of
tests/test_golden_trajectory.py (residual RMS rtol 0.01 / atol 5e-3, u
atol 0.02 max|u|) unless stated.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_sensorlessao_tpu.models import closed_loop as jcl
from mpc_sensorlessao_tpu.models import estimator as jestimator
from mpc_sensorlessao_tpu.models import pipeline as jpipeline
from mpc_sensorlessao_tpu.ops import zernike as jz
from mpc_sensorlessao_tpu.ops import zernike_stats as jzs
from mpc_sensorlessao_tpu.utils import config as jconfig
from mpc_sensorlessao_tpu_torch import interop, reference_config
from mpc_sensorlessao_tpu_torch import strong_turbulence
from mpc_sensorlessao_tpu_torch.models import closed_loop, estimator
from mpc_sensorlessao_tpu_torch.models import pipeline, var
from mpc_sensorlessao_tpu_torch.ops import zernike, zernike_stats
from mpc_sensorlessao_tpu_torch.parallel import montecarlo

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
# the suite runs one test file per worker process, several at once: one
# intra-op thread each keeps torch's thread pools from oversubscribing the
# cores (which slows small eager ops many times over)
torch.set_num_threads(1)

START = 350.0       # n_train + n_valid: the test window
D_OVER_R0 = 10.0
rep = dataclasses.replace


def _recipe(reference_config_fn, d=D_OVER_R0):
    """The recipe as the JAX sweep scripts set it up, cut to R=64, 300 +
    50 identification steps and 20 test steps."""
    cfg = reference_config_fn(resolution=64)
    return cfg.replace(
        zernike=rep(cfg.zernike, radial_order=10),
        mpc=rep(cfg.mpc, warm_start=True, var_ridge=1e-2, r_weight=30.0),
        estimator=rep(cfg.estimator, method="mmse",
                      prior_scale=min(0.15, 0.5 / d)),
        sim=rep(cfg.sim, n_train=300, n_valid=50, n_test=20, d_over_r0=d))


def _port_recipe(d=D_OVER_R0):
    """The port's recipe configuration, cut as _recipe cuts it."""
    cfg = strong_turbulence(reference_config(resolution=64), d)
    return cfg.replace(sim=rep(cfg.sim, n_train=300, n_valid=50, n_test=20))


def npy(t):
    return t.detach().cpu().numpy()


@pytest.fixture(scope="module")
def jax_recipe():
    cfg = _recipe(jconfig.reference_config)
    return cfg, jpipeline.build(cfg, jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def carried(jax_recipe):
    """The JAX recipe's loop operators (mmse estimator, map_reg included)
    and screens, carried across to the port."""
    _, system = jax_recipe
    return (interop.loop_models_from_numpy(
                jax.tree.map(np.asarray, system.loop), "cpu"),
            interop.layers_from_numpy(
                jax.tree.map(np.asarray, system.layers), "cpu"))


@pytest.fixture(scope="module")
def port_recipe():
    cfg = _port_recipe()
    return cfg, pipeline.build(cfg, "cpu")


@pytest.mark.parametrize("d", [5.0, 10.0, 20.0])
def test_strong_turbulence_config_is_the_scripts_recipe(d):
    """config.strong_turbulence gives the configuration the JAX sweep
    scripts build inline, at each D/r0."""
    assert (dataclasses.asdict(_port_recipe(d))
            == dataclasses.asdict(_recipe(jconfig.reference_config, d=d)))


# ------------------------------------------------------------ the prior

@pytest.mark.parametrize("order", [6, 10])
@pytest.mark.parametrize("fn", ["variance_analytic", "covariance_analytic"])
def test_zernike_stats_match_jax(fn, order):
    """The analytic Von Karman statistics, host float64 on both sides:
    rtol 1e-10."""
    cfg = reference_config(resolution=32)
    jcfg = jconfig.reference_config(resolution=32)
    got = getattr(zernike_stats, fn)(cfg.atmosphere, cfg.telescope.diameter,
                                     order)
    want = getattr(jzs, fn)(jcfg.atmosphere, jcfg.telescope.diameter, order)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=0)


def _prior(cfg, order, scale):
    C = zernike_stats.covariance_analytic(cfg.atmosphere,
                                          cfg.telescope.diameter, order)
    return C[1:, 1:] * scale ** 2


@pytest.mark.parametrize("order", [6, 10])
def test_mmse_estimator_matches_jax(order):
    """The mmse build (host float64 gain C A'(A C A' + sigma^2 I)^-1 and
    map_reg = sigma^2 C^-1) vs the JAX one on the same prior: solve_op to
    1e-4 of its scale, map_reg to 1e-5 relative."""
    cfg = reference_config(resolution=32)
    est_cfg = rep(cfg.estimator, method="mmse", prior_scale=0.1)
    prior = _prior(cfg, order, 0.1)
    ours = estimator.build(est_cfg, zernike.make_basis(order, 32, "cpu"),
                           prior_cov=prior, device="cpu")
    jcfg = jconfig.reference_config(resolution=32)
    theirs = jestimator.build(
        rep(jcfg.estimator, method="mmse", prior_scale=0.1),
        jz.make_basis(order, 32), prior_cov=prior)
    want = np.asarray(theirs.solve_op)
    np.testing.assert_allclose(npy(ours.solve_op), want, rtol=0,
                               atol=1e-4 * np.abs(want).max())
    want = np.asarray(theirs.map_reg)
    got = npy(ours.map_reg)
    assert got.shape == (ours.n_states,) * 2
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


def test_mmse_without_prior_raises():
    cfg = reference_config(resolution=32)
    with pytest.raises(ValueError, match="prior_cov"):
        estimator.build(rep(cfg.estimator, method="mmse"),
                        zernike.make_basis(6, 32, "cpu"), device="cpu")


# ------------------------------------------------- re-linearized estimate

@pytest.fixture(scope="module")
def ls_estimators():
    """The JAX LS estimator at R=32, order 6, and the port's copy."""
    jcfg = jconfig.reference_config(resolution=32)
    basis = jz.make_basis(6, 32)
    jest = jestimator.build(jcfg.estimator, basis)
    est = interop.estimator_from_numpy(jax.tree.map(np.asarray, jest), "cpu")
    return jest, est, np.array(basis.stack[1:])


def _phases(stack, rng, n, amp):
    x = (rng.normal(size=(n, stack.shape[0])) * amp).astype(np.float32)
    return x, np.einsum("bk,kij->bij", x, stack).astype(np.float32)


def test_linearize_at_matches_jax(ls_estimators):
    """linearize_at on a batch of 3 phases vs the JAX single-sample one
    under vmap: y0 and J to 1e-5 of their scale."""
    jest, est, stack = ls_estimators
    _, ph = _phases(stack, np.random.default_rng(0), 3, 0.3)
    y0, J = estimator.linearize_at(est, torch.as_tensor(ph),
                                   torch.as_tensor(stack))
    jy0, jJ = jax.vmap(lambda p: jestimator.linearize_at(
        jest, p, jnp.asarray(stack)))(jnp.asarray(ph))
    assert J.shape == (3, est.n_pixels, est.n_states)
    for got, want in ((y0, jy0), (J, jJ)):
        want = np.asarray(want)
        np.testing.assert_allclose(npy(got), want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("seeded", [False, True])
@pytest.mark.parametrize("method", ["ls", "mmse"])
def test_estimate_full_gn_matches_jax(ls_estimators, method, seeded):
    """Two Gauss-Newton iterations on a batch of 3 noisy measurements,
    cold or seeded near the truth, with the LS or the mmse estimator
    (map_reg, the MAP term about the seed), vs the JAX one per sample
    under vmap: x within 1e-3 of ||x_true||."""
    jest, est, stack = ls_estimators
    if method == "mmse":
        cfg = reference_config(resolution=32)
        jest = jestimator.build(
            rep(jconfig.reference_config(resolution=32).estimator,
                method="mmse", prior_scale=0.3),
            jz.make_basis(6, 32), prior_cov=_prior(cfg, 6, 0.3))
        est = interop.estimator_from_numpy(jax.tree.map(np.asarray, jest),
                                           "cpu")
    rng = np.random.default_rng(1)
    x_true, ph = _phases(stack, rng, 3, 0.15)
    y = np.asarray(jax.vmap(lambda p: jestimator.measure(jest, p))(
        jnp.asarray(ph)))
    y = (y + float(est.noise_std) * rng.standard_normal(y.shape)).astype(
        np.float32)
    seed = ((x_true + 0.05 * rng.normal(size=x_true.shape)).astype(
        np.float32) if seeded else None)
    got = estimator.estimate_full_gn(
        est, torch.as_tensor(y), torch.as_tensor(stack), 2,
        x_init=None if seed is None else torch.as_tensor(seed))
    if seeded:
        want = jax.vmap(lambda yy, s: jestimator.estimate_full_gn(
            jest, yy, jnp.asarray(stack), 2, x_init=s))(
                jnp.asarray(y), jnp.asarray(seed))
    else:
        want = jax.vmap(lambda yy: jestimator.estimate_full_gn(
            jest, yy, jnp.asarray(stack), 2))(jnp.asarray(y))
    want = np.asarray(want)
    assert np.isfinite(want).all()
    for i in range(3):
        np.testing.assert_allclose(
            npy(got[i]), want[i], rtol=0,
            atol=1e-3 * np.linalg.norm(x_true[i]))


def test_non_pd_scenario_keeps_its_base_estimate(jax_recipe, carried):
    """A batch of 3 where the Gauss-Newton matrix J'J + reg of scenario 0
    alone is not positive definite (map_reg given a negative rank-one
    part along that matrix's weakest direction; the other two are
    linearized at 0.3-rad phases, so their thresholds lie ~2x higher): the port's batched
    Cholesky gives NaN for scenario 0 only, as the JAX Cholesky solve
    does per sample, the other two match JAX (x within 1e-3 of their
    norm), and the tracking rule keeps scenario 0's base estimate
    exactly."""
    cfg, jsys = jax_recipe
    loop, _ = carried
    est = loop.est
    stack = npy(loop.state_stack)
    rng = np.random.default_rng(2)
    seed, ph = _phases(stack, rng, 3, 0.3)
    seed[0], ph[0] = 0.0, 0.0
    nx = est.n_states
    lam = 1e-3 * float(torch.trace(est.A_s.T @ est.A_s)) / nx
    _, J = estimator.linearize_at(est, torch.as_tensor(ph), loop.state_stack)
    J = npy(J).astype(np.float64)
    H = (np.swapaxes(J, 1, 2) @ J + lam * np.eye(nx)
         + npy(est.map_reg).astype(np.float64))
    v = np.linalg.eigh(H[0])[1][:, 0]
    # H_i - c v v' is singular at c = 1 / (v' H_i^-1 v): pick c between
    # scenario 0's threshold and the others'
    thresh = [1.0 / (v @ np.linalg.solve(Hi, v)) for Hi in H]
    assert thresh[0] * 1.5 < min(thresh[1:]), thresh
    c = np.sqrt(thresh[0] * min(thresh[1:]))
    map_reg = (npy(est.map_reg) - c * np.outer(v, v)).astype(np.float32)
    bad = rep(est, map_reg=torch.as_tensor(map_reg))
    jbad = jsys.loop.est.replace(map_reg=jnp.asarray(map_reg))
    y = estimator.measure(est, torch.as_tensor(
        ph + np.einsum("k,kij->ij", rng.normal(size=nx) * 0.05,
                       stack).astype(np.float32)))
    got = estimator.estimate_full_gn(bad, y, loop.state_stack, 1,
                                     x_init=torch.as_tensor(seed))
    want = np.asarray(jax.vmap(lambda yy, s: jestimator.estimate_full_gn(
        jbad, yy, jnp.asarray(stack), 1, x_init=s))(
            jnp.asarray(npy(y)), jnp.asarray(seed)))
    assert np.isnan(npy(got[0])).all() and np.isnan(want[0]).all()
    for i in (1, 2):
        np.testing.assert_allclose(npy(got[i]), want[i], rtol=0,
                                   atol=1e-3 * np.linalg.norm(want[i]))
    x0 = estimator.estimate(est, y)
    sig2 = torch.full((3,), float(est.noise_std) ** 2)
    x = closed_loop.track_estimate(rep(loop, est=bad), y, x0,
                                   torch.as_tensor(seed), sig2, 1)
    assert torch.equal(x[0], x0[0])
    assert torch.isfinite(x).all()


# ------------------------------------------------------------ warm start

def test_warm_start_command_matches_jax(jax_recipe, port_recipe):
    """warm_start_command (host float64) on the JAX system's open-loop
    series, VAR model and influence, carried into the port's System:
    within 1e-5 of the JAX command's scale."""
    cfg, jsys = jax_recipe
    pcfg, sys_ = port_recipe
    A = torch.as_tensor(np.array(jsys.var_model.A))
    carried_sys = rep(
        sys_, coeff_series=torch.as_tensor(np.array(jsys.coeff_series)),
        var_model=var.VARModel(A=A, order=jsys.var_model.order),
        dm_model=rep(sys_.dm_model, influence=torch.as_tensor(
            np.array(jsys.dm_model.influence))))
    start = cfg.sim.n_train + cfg.sim.n_valid
    got = npy(pipeline.warm_start_command(carried_sys, pcfg, start))
    want = np.array(jpipeline.warm_start_command(jsys, cfg, start))
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def test_warm_start_command_bounded_and_cancels():
    """The JAX test's properties (tests/test_configs.py, warm start) on
    the port's own build: max|u0| <= u_max/2 and the command cancels 80%
    of the VAR prediction's norm."""
    cfg = reference_config(resolution=64)
    cfg = cfg.replace(
        sim=rep(cfg.sim, n_train=300, n_valid=50, n_test=40),
        mpc=rep(cfg.mpc, warm_start=True))
    sys_ = pipeline.build(cfg, "cpu")
    start = cfg.sim.n_train + cfg.sim.n_valid
    u0 = npy(pipeline.warm_start_command(sys_, cfg, start)).astype(np.float64)
    assert np.abs(u0).max() <= 0.5 * cfg.mpc.u_max + 1e-6
    states = npy(sys_.coeff_series[:, 1:]).astype(np.float64)
    A = npy(sys_.var_model.A)
    x_pred = A[0] @ states[start - 1] + A[1] @ states[start - 2]
    resid = x_pred + npy(sys_.dm_model.influence).astype(np.float64) @ u0
    assert np.linalg.norm(resid) < 0.2 * np.linalg.norm(x_pred)


# ------------------------------------------------------------- the loop

def _assert_trajectory(u, rms, u_ref, rms_ref):
    np.testing.assert_allclose(rms, rms_ref, rtol=0.01, atol=5e-3)
    np.testing.assert_allclose(u, u_ref, atol=0.02 * np.abs(u_ref).max())


CASES = {
    # name: (config changes, warm start, steps)
    "mmse": ({}, False, 10),
    "warm_start": ({}, True, 10),
    "fusion": ({"mpc": {"est_gain": 0.9, "innovation_gate": 5.0}}, True,
               10),
    # innovations here are ~0.5 rad: a gate of 0.2 clamps every one
    "fusion_clamped": ({"mpc": {"est_gain": 0.9, "innovation_gate": 0.2}},
                       True, 10),
    # cold: the base estimate of step 0 (~0.9 rad residual) fails the
    # chi-square rule and the tracked one replaces it
    "tracking": ({"estimator": {"track_gn_iters": 1}}, False, 6),
}


def _with(cfg, changes):
    return cfg.replace(**{k: rep(getattr(cfg, k), **v)
                          for k, v in changes.items()})


@pytest.mark.parametrize("case", list(CASES))
def test_recipe_loop_matches_jax_with_carried_operators(jax_recipe, carried,
                                                        case, monkeypatch):
    """The port's loop on the JAX recipe's operators (mmse estimator with
    map_reg) vs the JAX loop, same injected noise: cold ("mmse"), from
    the JAX warm-start command, with the estimator-VAR fusion (est_gain
    0.9, innovation_gate 5, and a gate that clamps), and with the
    tracking estimator (one re-linearized Gauss-Newton iteration a step,
    6 steps from a cold start), whose rule must take the tracked
    estimate at least once."""
    picked = []
    track = closed_loop.track_estimate

    def recorded(models, y, x0, *args):
        x = track(models, y, x0, *args)
        picked.append(bool((x != x0).any()))
        return x
    monkeypatch.setattr(closed_loop, "track_estimate", recorded)
    cfg, jsys = jax_recipe
    loop, layers = carried
    changes, warm, n_steps = CASES[case]
    jcfg = _with(cfg, changes)
    pcfg = _with(_port_recipe(), changes)
    init_u = (np.array(jpipeline.warm_start_command(jsys, cfg, int(START)))
              if warm else None)
    rng = np.random.default_rng(7)
    noise = (float(loop.est.noise_std) * rng.standard_normal(
        (n_steps, loop.est.n_pixels))).astype(np.float32)
    ref = jcl.simulate(jsys.loop, jsys.layers, jcfg, jax.random.PRNGKey(9),
                       n_steps=n_steps, start_step=START, noise_scale=1.0,
                       noise_seq=jnp.asarray(noise),
                       init_u=None if init_u is None else jnp.asarray(init_u))
    out = closed_loop.simulate(
        loop, layers, pcfg, None, n_steps=n_steps, start_step=START,
        noise_seq=torch.as_tensor(noise),
        init_u=None if init_u is None else torch.as_tensor(init_u))
    for field in out:
        assert torch.isfinite(field).all()
    _assert_trajectory(npy(out.u), npy(out.rms_res), np.asarray(ref.u),
                       np.asarray(ref.rms_res))
    np.testing.assert_allclose(npy(out.du), np.asarray(ref.du),
                               atol=0.02 * np.abs(np.asarray(ref.u)).max())
    assert any(picked) == (case == "tracking"), picked


def test_run_batch_warm_start_matches_jax_vmap(jax_recipe, carried):
    """run_batch(init_u=...) over 3 shared-window scenarios at three SNRs
    vs the JAX call the sweep scripts make, vmap(simulate(init_u=...))
    (benchmarks/montecarlo_sweep.py), fed the noise the port's generator
    drew; the batched-window path applies init_u too and agrees with the
    shared one (float32 blend roundoff, as in test_torch_loop.py)."""
    cfg, jsys = jax_recipe
    loop, layers = carried
    pcfg = _port_recipe()
    n_steps = 8
    init_u = np.array(jpipeline.warm_start_command(jsys, cfg, int(START)))
    scen = montecarlo.make_scenarios(
        pcfg, torch.Generator().manual_seed(4), 3,
        d_over_r0_grid=(D_OVER_R0,), snr_db_grid=(5.0, 20.0, 40.0),
        device="cpu")
    iu = torch.as_tensor(init_u)
    out = montecarlo.run_batch(loop, layers, pcfg, scen, n_steps,
                               shared_window="verified", init_u=iu)
    batched = montecarlo.run_batch(loop, layers, pcfg, scen, n_steps,
                                   init_u=iu)
    gen = torch.Generator().manual_seed(scen.noise_seed)
    draws = torch.stack([estimator.sample_noise(loop.est, gen, (3,))
                         for _ in range(n_steps)], dim=1).numpy()
    ref = jax.vmap(lambda m, s, nz: jcl.simulate(
        jsys.loop, jsys.layers, cfg, jax.random.PRNGKey(0),
        n_steps=n_steps, start_step=START, mag=m, noise_scale=s,
        noise_seq=nz, init_u=jnp.asarray(init_u)))(
            jnp.asarray(npy(scen.mag)), jnp.asarray(npy(scen.noise_scale)),
            jnp.asarray(draws))
    assert out.u.shape == (3, n_steps, loop.influence.shape[1])
    for i in range(3):
        _assert_trajectory(npy(out.u[i]), npy(out.rms_res[i]),
                           np.asarray(ref.u[i]), np.asarray(ref.rms_res[i]))
    scale = float(out.u.abs().max())
    torch.testing.assert_close(batched.u, out.u, rtol=0, atol=1e-4 * scale)
    torch.testing.assert_close(batched.rms_res, out.rms_res, rtol=1e-4,
                               atol=1e-6)


# ----------------------------------------------------------- the builds

def test_with_horizon_matches_build():
    """with_horizon(build(N=2), N=4) builds exactly the controller
    build(N=4) builds: every MPC matrix and fixed Newton operator within
    1e-6 relative."""
    cfg = reference_config(resolution=32)
    cfg = cfg.replace(sim=rep(cfg.sim, n_train=120, n_valid=20, n_test=10))
    cfg4 = cfg.replace(mpc=rep(cfg.mpc, horizon=4))
    got = pipeline.with_horizon(pipeline.build(cfg, "cpu"), cfg4)
    want = pipeline.build(cfg4, "cpu")
    assert got.loop.mats.horizon == 4
    for ours, theirs in ((got.mats, want.mats),
                         (got.loop.fixed_op, want.loop.fixed_op),
                         (got.loop.prob, want.loop.prob)):
        for f in dataclasses.fields(theirs):
            a, b = getattr(ours, f.name), getattr(theirs, f.name)
            if isinstance(b, torch.Tensor):
                assert a.shape == b.shape, f.name
                torch.testing.assert_close(
                    a, b, rtol=1e-6, atol=1e-6 * float(b.abs().max()),
                    msg=f.name)
            else:
                assert a == b, f.name


def test_with_horizon_matches_jax():
    """with_horizon(build(N=2), N=4) in the port vs the JAX package's, at
    R=32, on the same float32 VAR model and DM (the JAX build's, carried
    across, so the VAR fit's precision is held apart): every MPC design
    matrix within 1e-4 of its scale, the tolerance tests/test_torch_loop.py
    holds the float64 port against the float32 JAX package to.

    closed_form = -0.5 pinv(H'H) H' is left out: H'H has condition ~3e7
    here, and the float32 pinv cutoff (10 n eps) drops 480 of its 576
    directions in the JAX build, none in the port's float64 one; the
    port's own design_matrices is held against JAX's in float32 by
    tests/test_torch_ops.py."""
    jcfg = jconfig.reference_config(resolution=32)
    jcfg = jcfg.replace(sim=rep(jcfg.sim, n_train=120, n_valid=20,
                                n_test=10))
    jcfg4 = jcfg.replace(mpc=rep(jcfg.mpc, horizon=4))
    want = jpipeline.with_horizon(
        jpipeline.build(jcfg, jax.random.PRNGKey(0)), jcfg4).mats
    jsys = jpipeline.build(jcfg, jax.random.PRNGKey(0))
    cfg = reference_config(resolution=32)
    cfg = cfg.replace(sim=rep(cfg.sim, n_train=120, n_valid=20, n_test=10))
    cfg4 = cfg.replace(mpc=rep(cfg.mpc, horizon=4))
    own = pipeline.build(cfg, "cpu")
    own = dataclasses.replace(
        own,
        var_model=var.VARModel(
            A=torch.tensor(np.asarray(jsys.var_model.A), dtype=torch.float64),
            order=jsys.var_model.order),
        dm_model=dataclasses.replace(
            own.dm_model,
            influence=torch.tensor(np.asarray(jsys.dm_model.influence))))
    got = pipeline.with_horizon(own, cfg4).mats
    assert got.horizon == want.horizon == 4
    for f in dataclasses.fields(got):
        if f.name in ("horizon", "closed_form"):
            continue
        a, b = npy(getattr(got, f.name)), np.asarray(getattr(want, f.name))
        assert a.shape == b.shape, f.name
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=1e-4 * np.abs(b).max(), err_msg=f.name)


def test_own_recipe_build_matches_jax(jax_recipe, port_recipe):
    """The port's own build of the recipe (R=64, order 10, D/r0=10) and
    loop from its own warm start vs the JAX package's, noise free, 20
    steps: the settled residual RMS (mean over the last half) within
    rtol 0.01 / atol 5e-3."""
    jcfg, jsys = jax_recipe
    cfg, sys_ = port_recipe
    n_steps = 20
    zero = np.zeros((n_steps, sys_.est.n_pixels), np.float32)
    ref = jcl.simulate(
        jsys.loop, jsys.layers, jcfg, jax.random.PRNGKey(9),
        n_steps=n_steps, start_step=START, noise_scale=1.0,
        noise_seq=jnp.asarray(zero),
        init_u=jpipeline.warm_start_command(jsys, jcfg, int(START)))
    out = closed_loop.simulate(
        sys_.loop, sys_.layers, cfg, None, n_steps=n_steps,
        start_step=START, noise_seq=torch.as_tensor(zero),
        init_u=pipeline.warm_start_command(sys_, cfg, int(START)))
    assert sys_.est.map_reg is not None
    settled = out.rms_res[n_steps // 2:].mean().item()
    settled_ref = float(np.asarray(ref.rms_res)[n_steps // 2:].mean())
    np.testing.assert_allclose(settled, settled_ref, rtol=0.01, atol=5e-3)
