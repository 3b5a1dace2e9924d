"""The PyTorch port's closed loop vs the JAX package's, at R=64.

(a) The JAX operators are carried across with ``interop`` and both
    engines run the same loop with the same injected measurement noise
    (closed_loop.simulate(noise_seq=...)), so the control step is tested
    apart from the build; the shared-window Monte-Carlo batch is held
    against per-scenario JAX runs.
(b) The port's own ``pipeline.build`` and loop are held against the JAX
    package's, noise-free.
(c) closed_loop.make_step's step, driven by hand, is simulate's loop.
Tolerances are those of tests/test_golden_trajectory.py: residual RMS
rtol 0.01 / atol 5e-3 and u atol 0.02 max|u|, unless stated.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_sensorlessao_tpu.models import closed_loop as jcl
from mpc_sensorlessao_tpu.models import estimator as jestimator
from mpc_sensorlessao_tpu.utils import metrics as jmetrics
from mpc_sensorlessao_tpu_torch import interop, reference_config
from mpc_sensorlessao_tpu_torch.models import closed_loop, estimator
from mpc_sensorlessao_tpu_torch.models import pipeline
from mpc_sensorlessao_tpu_torch.parallel import montecarlo
from mpc_sensorlessao_tpu_torch.utils import metrics
from torch_loop_support import (START, _assert_trajectory,  # noqa: F401
                                _cfg, _check_carried_loop,
                                _check_run_batch_paths, _port_loop,
                                carried, jax_system, port_system)


def test_estimator_matches_jax(jax_system, port_system):
    """The port's estimator build (complex128 linearization, float64 host
    solve) vs the JAX one (complex64 linearization): A_s, b_s, noise_std
    to 1e-5 of their scale; solve_op, through the (A'A)^-1 of
    condition ~1e4, to 1e-4 of its scale."""
    _, jsys = jax_system
    _, sys_ = port_system
    ours, theirs = sys_.est, jsys.loop.est
    for name, tol in (("A_s", 1e-5), ("b_s", 1e-5), ("noise_std", 1e-5),
                      ("solve_op", 1e-4)):
        want = np.asarray(getattr(theirs, name))
        got = getattr(ours, name).numpy()
        assert got.shape == want.shape, name
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=tol * np.abs(want).max(),
                                   err_msg=name)
    # the loop's measure on one phase: the B1 plain version vs the JAX
    # unfused path (rtol/atol 2e-4 of the unit-scale PSF, test_pallas)
    rng = np.random.default_rng(0)
    ph = (rng.normal(size=(2, 64, 64)) * 0.3).astype(np.float32)
    want = np.asarray(jestimator.measure(theirs, jnp.asarray(ph)))
    got = estimator.measure(ours, torch.as_tensor(ph)).numpy()
    peak = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4 * peak)


def test_interop_carries_the_measure_switch(jax_system, carried):
    """estimator_from_numpy carries div_sym3 and the diversity cos/sin
    maps across unchanged, absent maps included."""
    _, jsys = jax_system
    loop, _ = carried
    assert loop.est.div_sym3 is True
    np.testing.assert_array_equal(loop.est.div_cos.numpy(),
                                  np.asarray(jsys.loop.est.div_cos))
    jest = jsys.loop.est.replace(div_cos=None, div_sin=None, div_sym3=False)
    est = interop.estimator_from_numpy(jax.tree.map(np.asarray, jest), "cpu")
    assert est.div_cos is None and est.div_sin is None
    assert est.div_sym3 is False


@pytest.mark.parametrize("solver,newton_steps", [
    pytest.param("fastmpc", 1, id="fastmpc"),
    pytest.param("closed_form", 1, id="closed_form"),
    pytest.param("fastmpc_ramp", 1, id="fastmpc_ramp"),
    pytest.param("fastmpc", 2, id="fastmpc-newton_steps=2")])
@pytest.mark.parametrize("noisy", [False, True])
def test_simulate_matches_jax_with_carried_operators(jax_system, carried,
                                                     solver, newton_steps,
                                                     noisy):
    """The port's loop on the JAX operators, measuring through the
    build's default route (B1's plain version), vs the JAX loop
    (use_pallas=False, its jnp reference), same injected noise, through
    every solver of the switch: the fixed Newton step, the closed form,
    ADMM (400 iterations, ramp bounds shifted by u[k-1]), the ramp rows
    with the running u[k-1], and the general Newton solve."""
    _check_carried_loop(jax_system, carried, solver, noisy, "sym3",
                        newton_steps=newton_steps)


@pytest.mark.parametrize("route", ["general", "unfused"])
@pytest.mark.parametrize("solver", ["fastmpc", "closed_form"])
@pytest.mark.parametrize("noisy", [False, True])
def test_simulate_matches_jax_through_each_route(jax_system, carried,
                                                 solver, noisy, route):
    """As test_simulate_matches_jax_with_carried_operators, with the
    port measuring through the other routes: B2's and B3's plain
    versions."""
    _check_carried_loop(jax_system, carried, solver, noisy, route)


def test_interop_carries_dft_dtype(jax_system):
    """estimator_from_numpy carries the JAX estimator's dft_dtype across:
    "bfloat16" as set by replace on the built JAX estimator, and the
    build's "float32"."""
    _, jsys = jax_system
    for dft_dtype in ("bfloat16", "float32"):
        jest = jsys.loop.est.replace(dft_dtype=dft_dtype)
        est = interop.estimator_from_numpy(jax.tree.map(np.asarray, jest),
                                           "cpu")
        assert est.dft_dtype == dft_dtype


@pytest.mark.parametrize("route", ["sym3", "general", "unfused"])
def test_simulate_bf16_matches_jax_through_each_route(jax_system, carried,
                                                      route):
    """The loop with dft_dtype="bfloat16" (the JAX estimator replaced,
    carried across by interop) on each route vs the JAX loop with the
    same estimator and injected noise (fastmpc), the JAX loop measuring
    through its non-kernel path, whose rounding points are B3's: the
    trajectory at _assert_trajectory's tolerances (u within 6.1e-3 of
    max|u| here, residual RMS within 4.4e-3 relative), the exact Strehl at
    atol 5e-4 on every route (|difference| at most 2.9e-4 sym3, 3.3e-4
    general, 2.1e-4 unfused here).  On equal phases the unfused measure
    is the JAX one to 1e-8 of the peak, but the two loops' phases differ
    in float32 (the float32 loops' u by 2.5e-6 of max|u|), and bf16
    rounding turns that into a one-ulp flip of a field or stage-1 element
    now and then; a stage-1 flip moves a crop pixel by up to ~1e-4 of the
    peak, and the estimator carries it into the following steps (with
    noise seed 8: exact Strehl within 4.9e-4 sym3, 3.3e-4 general and
    unfused).

    The port's loop measures in bf16, not float32: the same loop with
    the estimator's dft_dtype="float32" is at least twice as far from
    the JAX bf16 loop in exact Strehl (1.1e-3 here, 3.3-5.3x the bf16
    loop's distance) and in u at the first step, whose measure takes
    equal commands (2.6e-3 of max|u|, against 1.7e-4 general and
    unfused and 1.1e-3 sym3, whose rounding points are not those of the
    JAX loop's measure)."""
    ref, out, loop, noise = _check_carried_loop(
        jax_system, carried, "fastmpc", True, route, dft_dtype="bfloat16",
        strehl_atol=5e-4)
    f32 = _port_loop(dataclasses.replace(loop, est=dataclasses.replace(
        loop.est, dft_dtype="float32")), carried[1], "fastmpc", noise)
    u_ref, strehl_ref = np.asarray(ref.u), np.asarray(ref.strehl_exact)
    scale = np.abs(u_ref).max()

    def far(o):
        return (np.abs(o.strehl_exact.numpy() - strehl_ref).max(),
                np.abs(o.u.numpy()[0] - u_ref[0]).max() / scale)
    (strehl_bf16, u0_bf16), (strehl_f32, u0_f32) = far(out), far(f32)
    assert strehl_bf16 < strehl_f32 / 2, (strehl_bf16, strehl_f32)
    assert u0_bf16 < u0_f32 / 2, (u0_bf16, u0_f32)


def test_run_batch_shared_window_matches_jax_per_scenario(jax_system,
                                                          carried):
    """Shared-window run_batch over B=3 scenarios with distinct D/r0 and
    SNR vs one JAX simulate per scenario, fed the same noise the port's
    generator drew (replayed from the batch's seed)."""
    cfg, jsys = jax_system
    loop, layers = carried
    pcfg = _cfg(reference_config)
    n_steps, p = 8, loop.est.n_pixels
    scen = montecarlo.make_scenarios(
        pcfg, torch.Generator().manual_seed(4), 3,
        d_over_r0_grid=(5.0, 8.0), snr_db_grid=(10.0, 20.0), device="cpu")
    out = montecarlo.run_batch(loop, layers, pcfg, scen, n_steps,
                               shared_window="verified")
    gen = torch.Generator().manual_seed(scen.noise_seed)
    draws = torch.stack([estimator.sample_noise(loop.est, gen, (3,))
                         for _ in range(n_steps)], dim=1).numpy()
    assert out.u.shape == (3, n_steps, loop.influence.shape[1])
    for i in range(3):
        ref = jcl.simulate(
            jsys.loop, jsys.layers, cfg, jax.random.PRNGKey(0),
            n_steps=n_steps, start_step=START, mag=float(scen.mag[i]),
            noise_scale=float(scen.noise_scale[i]),
            noise_seq=jnp.asarray(draws[i]))
        _assert_trajectory(out.u[i].numpy(), out.rms_res[i].numpy(),
                           np.asarray(ref.u), np.asarray(ref.rms_res))


def test_run_batch_batched_window_matches_shared(port_system):
    """The per-scenario window gather gives the shared window's
    trajectories (float32 blend roundoff only): when all starts agree,
    run_batch's two paths agree; with distinct starts (start_range) each
    scenario of the batched loop equals a shared-window loop at its own
    start with the same injected noise."""
    cfg, sys_ = port_system
    scen = montecarlo.make_scenarios(cfg, torch.Generator().manual_seed(2),
                                     2, device="cpu")
    shared = montecarlo.run_batch(sys_.loop, sys_.layers, cfg, scen, 6,
                                  shared_window=True)
    batched = montecarlo.run_batch(sys_.loop, sys_.layers, cfg, scen, 6)
    scale = float(shared.u.abs().max())
    torch.testing.assert_close(batched.u, shared.u, rtol=0,
                               atol=1e-4 * scale)
    torch.testing.assert_close(batched.rms_res, shared.rms_res, rtol=1e-4,
                               atol=1e-6)

    moved = montecarlo.make_scenarios(
        cfg, torch.Generator().manual_seed(2), 2, start_range=(350, 400),
        device="cpu")
    assert float(moved.start_step[0]) != float(moved.start_step[1])
    with pytest.raises(ValueError, match="distinct start_steps"):
        montecarlo.run_batch(sys_.loop, sys_.layers, cfg, moved, 2,
                             shared_window=True)
    rng = np.random.default_rng(3)
    seq = torch.as_tensor((float(sys_.est.noise_std) * rng.standard_normal(
        (2, 6, sys_.est.n_pixels))).astype(np.float32))
    both = closed_loop.simulate(sys_.loop, sys_.layers, cfg, None, 6,
                                start_step=moved.start_step, mag=moved.mag,
                                noise_seq=seq)
    for i in range(2):
        one = closed_loop.simulate(
            sys_.loop, sys_.layers, cfg, None, 6,
            start_step=float(moved.start_step[i]), mag=float(moved.mag[i]),
            noise_seq=seq[i])
        torch.testing.assert_close(both.u[i], one.u, rtol=0,
                                   atol=1e-4 * scale)
        torch.testing.assert_close(both.rms_res[i], one.rms_res, rtol=1e-4,
                                   atol=1e-6)
    assert not torch.allclose(both.rms_turb[0], both.rms_turb[1])


def test_own_build_matches_jax_settled_residual(jax_system, port_system):
    """(b) The port's own build + loop vs the JAX build + loop, noise
    free, 20 steps.  The builds differ in precision (the port fits the
    VAR model and the MPC operators in float64, the JAX package in
    float32), so the trajectories are not step-identical; the settled
    residual RMS (mean over the last half) agrees within 2%."""
    jcfg, jsys = jax_system
    cfg, sys_ = port_system
    n_steps = 20
    zero = np.zeros((n_steps, sys_.est.n_pixels), np.float32)
    ref = jcl.simulate(jsys.loop, jsys.layers, jcfg, jax.random.PRNGKey(9),
                       n_steps=n_steps, start_step=START, noise_scale=1.0,
                       noise_seq=jnp.asarray(zero))
    out = closed_loop.simulate(sys_.loop, sys_.layers, cfg, None,
                               n_steps=n_steps, start_step=START,
                               noise_seq=torch.as_tensor(zero))
    settled = out.rms_res[n_steps // 2:].mean().item()
    settled_ref = float(np.asarray(ref.rms_res)[n_steps // 2:].mean())
    assert abs(settled - settled_ref) <= 0.02 * settled_ref
    # the screens and the open-loop series are built the same way
    np.testing.assert_array_equal(sys_.layers.screens.numpy(),
                                  np.asarray(jsys.layers.screens))
    want = np.asarray(jsys.coeff_series)
    np.testing.assert_allclose(sys_.coeff_series.numpy(), want, rtol=0,
                               atol=1e-4 * np.abs(want).max())


def test_own_build_matches_jax_settled_exact_strehl(jax_system, port_system):
    """(b) ROADMAP C.9: the port's own build + loop vs the JAX build +
    loop on the settled exact Strehl (mean over the last half of 20
    steps), each run on the same injected measurement noise, noise_std
    z with z from np.random.default_rng(100 + k), k = 0..5.  Measured
    at R=64 on these six streams: the port sits 2.1e-5 to 3.4e-5 below
    JAX (the float64 against the float32 VAR fit and MPC operators);
    the limit, 1e-4, fails a shift of 0.0005 -- the size of the TPU
    records' offset from both builds on the CPU -- which the settled
    residual test above would pass."""
    jcfg, jsys = jax_system
    cfg, sys_ = port_system
    n_steps = 20
    std = float(sys_.est.noise_std)
    assert std == pytest.approx(float(jsys.loop.est.noise_std), rel=1e-6)
    for k in range(6):
        z = np.random.default_rng(100 + k).standard_normal(
            (n_steps, sys_.est.n_pixels))
        seq = (std * z).astype(np.float32)
        ref = jcl.simulate(jsys.loop, jsys.layers, jcfg,
                           jax.random.PRNGKey(9), n_steps=n_steps,
                           start_step=START, noise_scale=1.0,
                           noise_seq=jnp.asarray(seq))
        out = closed_loop.simulate(sys_.loop, sys_.layers, cfg, None,
                                   n_steps=n_steps, start_step=START,
                                   noise_seq=torch.as_tensor(seq))
        got = float(out.strehl_exact[n_steps // 2:].mean())
        want = float(np.asarray(ref.strehl_exact)[n_steps // 2:].mean())
        assert abs(got - want) <= 1e-4, (k, got, want)


def test_run_closed_loop_and_summary(port_system):
    """pipeline.run_closed_loop with seeded noise locks the loop (healthy
    per the JAX package's drive: rejection > 1.5, Strehl > 0.9 at D/r0=5,
    R=64, 20 steps) and metrics.summarize agrees with the JAX summary of
    the same telemetry."""
    cfg, sys_ = port_system
    out = pipeline.run_closed_loop(sys_, cfg,
                                   torch.Generator().manual_seed(1))
    summ = metrics.to_dict(metrics.summarize(out))
    assert summ["rejection"] > 1.5
    assert summ["mean_strehl_exact"] > 0.9
    jout = jcl.StepOutputs(*(jnp.asarray(f.numpy()) for f in out))
    want = jmetrics.to_dict(jmetrics.summarize(jout))
    assert set(summ) == set(want)
    for k in summ:
        assert summ[k] == pytest.approx(want[k], rel=1e-5), k


def test_var1_ramp_loop_on_own_build():
    """BASELINE config 1 on the port's own build (tests/test_configs.py::
    test_var1_pipeline_with_ramp_solver): VAR(1) with the active ramp
    rows of solver fastmpc_ramp, R=64, 40 steps.  A2 is zero in the
    problem, every step keeps the ramp bound (du within 1.01 du_max) and
    the loop converges (residual over the last 10 steps below 0.75x the
    turbulence)."""
    cfg = reference_config(resolution=64)
    cfg = cfg.replace(
        sim=dataclasses.replace(cfg.sim, n_train=300, n_valid=50, n_test=40),
        mpc=dataclasses.replace(cfg.mpc, var_order=1, solver="fastmpc_ramp"))
    sys_ = pipeline.build(cfg, "cpu")
    assert float(sys_.loop.prob.A2.abs().max()) == 0.0
    out = pipeline.run_closed_loop(sys_, cfg,
                                   torch.Generator().manual_seed(1))
    assert float(out.du.abs().max()) <= cfg.mpc.du_max * 1.01
    assert (float(out.rms_res[-10:].mean())
            < 0.75 * float(out.rms_turb[-10:].mean()))


@pytest.mark.parametrize("solver,newton_steps", [
    ("fastmpc_ramp", 1), ("fastmpc", 2)])
def test_run_batch_paths_take_every_solver(port_system, monkeypatch, solver,
                                           newton_steps):
    """Each new branch of the solver switch calls its solver once a step
    and runs through run_batch's shared and batched windows (equal trajectories, as
    test_run_batch_batched_window_matches_shared) and through
    with_horizon(N=16); at N=16 >= CR_MIN_HORIZON the general Newton
    solve's cyclic reduction gives the loop of the dense Schur factor
    (CR_MIN_HORIZON raised past N) to u atol 1e-4 max|u|."""
    _check_run_batch_paths(port_system, monkeypatch, solver, newton_steps)


@functools.lru_cache(maxsize=None)
def _system32(flow):
    cfg = reference_config(resolution=32)
    cfg = cfg.replace(
        sim=dataclasses.replace(cfg.sim, n_train=120, n_valid=20, n_test=4),
        atmosphere=dataclasses.replace(cfg.atmosphere, flow=flow))
    return cfg, pipeline.build(cfg, "cpu")


@pytest.mark.parametrize("source", ["shared_window", "per_scenario_windows",
                                    "conditional_flow"])
def test_make_step_driven_by_hand_is_simulate(source):
    """make_step's step, driven by hand from its first carry for 4 steps
    at R=32 over 3 scenarios, gives simulate's outputs bit for bit, and
    its last carry holds the last command and estimate: on the shared
    window and on per-scenario windows (T1's plain version), both with
    the noise drawn from equally seeded generators, and on per-scenario
    conditional flows with injected border and measurement noise."""
    n_steps = 4
    cfg, sys_ = _system32("conditional" if source == "conditional_flow"
                          else "periodic")
    rng = np.random.default_rng(11)
    kw = dict(mag=torch.tensor([1.0, 1.2, 1.4]), start_step=140.0)
    if source == "per_scenario_windows":
        kw["start_step"] = torch.tensor([140.0, 147.0, 163.0])
    if source == "conditional_flow":
        model = sys_.edge_model
        kw.update(
            start_step=torch.tensor([140.0, 143.0, 151.0]), edge_model=model,
            edge_state=sys_.edge_state,
            edge_eps=torch.as_tensor(rng.standard_normal(
                (3, n_steps, model.k_max + 1, model.n_layers, model.n_border)
            ).astype(np.float32)),
            noise_seq=torch.as_tensor(
                (float(sys_.est.noise_std) * rng.standard_normal(
                    (3, n_steps, sys_.est.n_pixels))).astype(np.float32)))

    def gen():
        return (None if "noise_seq" in kw
                else torch.Generator().manual_seed(5))
    want = closed_loop.simulate(sys_.loop, sys_.layers, cfg, gen(), n_steps,
                                **kw)
    carry, step, batch = closed_loop.make_step(sys_.loop, sys_.layers, cfg,
                                               gen(), n_steps, **kw)
    assert batch == (3,)
    assert (carry.flow is None) == (source != "conditional_flow")
    steps = []
    for idx in range(n_steps):
        carry, out = step(carry, idx)
        steps.append(out)
    for name, col in zip(closed_loop.StepOutputs._fields, zip(*steps)):
        assert torch.equal(torch.stack(col, dim=1), getattr(want, name)), name
    assert torch.equal(carry.u1, want.u[:, -1])
    assert torch.equal(carry.x_pre, want.x_est[:, -1])
