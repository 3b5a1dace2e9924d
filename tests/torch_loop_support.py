"""Fixtures and checks shared by the port's closed-loop test files
(tests/test_torch_loop*.py, tests/test_torch_edge_flow.py), at R=64.

(a) The JAX operators are carried across with ``interop`` and both
    engines run the same loop with the same injected measurement noise
    (closed_loop.simulate(noise_seq=...)), so the control step is tested
    apart from the build.
(b) The port's own ``pipeline.build`` and loop are held against the JAX
    package's.
Tolerances are those of tests/test_golden_trajectory.py: residual RMS
rtol 0.01 / atol 5e-3 and u atol 0.02 max|u|, unless stated.

The fixtures are module-scoped: each test file that imports them builds
its own systems once.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_sensorlessao_tpu.models import closed_loop as jcl
from mpc_sensorlessao_tpu.models import pipeline as jpipeline
from mpc_sensorlessao_tpu.utils import config as jconfig
from mpc_sensorlessao_tpu_torch import interop, reference_config
from mpc_sensorlessao_tpu_torch.models import closed_loop, estimator
from mpc_sensorlessao_tpu_torch.models import pipeline
from mpc_sensorlessao_tpu_torch.parallel import montecarlo

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
# the suite runs one test file per worker process, several at once: one
# intra-op thread each keeps torch's thread pools from oversubscribing the
# cores (which slows small eager ops many times over)
torch.set_num_threads(1)

START = 350.0       # n_train + n_valid: the test window


def _cfg(reference_config_fn):
    cfg = reference_config_fn(resolution=64)
    return cfg.replace(sim=dataclasses.replace(
        cfg.sim, n_train=300, n_valid=50, n_test=20))


@pytest.fixture(scope="module")
def jax_system():
    cfg = _cfg(jconfig.reference_config)
    return cfg, jpipeline.build(cfg, jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def carried(jax_system):
    """The JAX loop operators and screens, carried across to the port."""
    _, system = jax_system
    return (interop.loop_models_from_numpy(
                jax.tree.map(np.asarray, system.loop), "cpu"),
            interop.layers_from_numpy(
                jax.tree.map(np.asarray, system.layers), "cpu"))


@pytest.fixture(scope="module")
def port_system():
    cfg = _cfg(reference_config)
    return cfg, pipeline.build(cfg, "cpu")


def _assert_trajectory(u, rms, u_ref, rms_ref):
    np.testing.assert_allclose(rms, rms_ref, rtol=0.01, atol=5e-3)
    np.testing.assert_allclose(u, u_ref, atol=0.02 * np.abs(u_ref).max())


def _check_carried_loop(jax_system, carried, solver, noisy, route,
                        dft_dtype="float32", strehl_atol=1e-4,
                        newton_steps=1):
    cfg, jsys = jax_system
    cfg = cfg.replace(mpc=dataclasses.replace(cfg.mpc,
                                              newton_steps=newton_steps))
    loop, layers = carried
    jloop = jsys.loop
    if dft_dtype != "float32":
        jloop = jloop._replace(est=jloop.est.replace(dft_dtype=dft_dtype))
        loop = dataclasses.replace(loop, est=interop.estimator_from_numpy(
            jax.tree.map(np.asarray, jloop.est), "cpu"))
    loop = dataclasses.replace(loop, est=estimator.with_route(loop.est,
                                                              route))
    n_steps, p = 10, loop.est.n_pixels
    noise = np.zeros((n_steps, p), np.float32)
    if noisy:
        rng = np.random.default_rng(7)
        noise = (float(loop.est.noise_std)
                 * rng.standard_normal((n_steps, p))).astype(np.float32)
    ref = jcl.simulate(jloop, jsys.layers, cfg, jax.random.PRNGKey(9),
                       n_steps=n_steps, start_step=START, solver=solver,
                       noise_scale=1.0, noise_seq=jnp.asarray(noise))
    out = _port_loop(loop, layers, solver, noise, newton_steps)
    assert out.u.shape == (n_steps, loop.influence.shape[1])
    for field in out:
        assert torch.isfinite(field).all()
    _assert_trajectory(out.u.numpy(), out.rms_res.numpy(),
                       np.asarray(ref.u), np.asarray(ref.rms_res))
    # exact Strehl from the same crops: float32 roundoff only (bf16: see
    # test_simulate_bf16_matches_jax_through_each_route)
    np.testing.assert_allclose(out.strehl_exact.numpy(),
                               np.asarray(ref.strehl_exact), atol=strehl_atol)
    return ref, out, loop, noise


def _port_loop(loop, layers, solver, noise, newton_steps=1):
    """The port's loop from START with injected noise (steps, pixels)."""
    cfg = _cfg(reference_config)
    cfg = cfg.replace(mpc=dataclasses.replace(cfg.mpc,
                                              newton_steps=newton_steps))
    return closed_loop.simulate(loop, layers, cfg, None,
                                n_steps=len(noise), start_step=START,
                                solver=solver,
                                noise_seq=torch.as_tensor(noise))


def _check_run_batch_paths(port_system, monkeypatch, solver, newton_steps):
    """The body of test_run_batch_paths_take_every_solver (its docstring
    says what it holds)."""
    cfg, sys_ = port_system
    cfg = cfg.replace(mpc=dataclasses.replace(
        cfg.mpc, solver=solver, newton_steps=newton_steps))
    scen = montecarlo.make_scenarios(cfg, torch.Generator().manual_seed(2),
                                     2, device="cpu")
    # the branch's solver runs once a step (the general Newton solve's
    # loop is within 3e-6 of the fixed step's, so only this tells them
    # apart)
    module, name = ((closed_loop.solvers, "admm_condensed")
                    if solver == "admm" else (closed_loop.newton_kkt, "solve"))
    calls, solve = [], getattr(module, name)
    monkeypatch.setattr(module, name,
                        lambda *a, **k: calls.append(1) or solve(*a, **k))
    shared = montecarlo.run_batch(sys_.loop, sys_.layers, cfg, scen, 4,
                                  shared_window=True)
    assert len(calls) == 4
    batched = montecarlo.run_batch(sys_.loop, sys_.layers, cfg, scen, 4)
    scale = float(shared.u.abs().max())
    torch.testing.assert_close(batched.u, shared.u, rtol=0,
                               atol=1e-4 * scale)
    for field in shared:
        assert torch.isfinite(field).all()
    long = cfg.replace(mpc=dataclasses.replace(cfg.mpc, horizon=16))
    sys16 = pipeline.with_horizon(sys_, long)
    out = montecarlo.run_batch(sys16.loop, sys16.layers, long, scen, 4,
                               shared_window=True)
    assert torch.isfinite(out.u).all()
    if solver == "fastmpc":
        monkeypatch.setattr(closed_loop.newton_kkt, "CR_MIN_HORIZON", 10_000)
        dense = montecarlo.run_batch(sys16.loop, sys16.layers, long, scen, 4,
                                     shared_window=True)
        torch.testing.assert_close(out.u, dense.u, rtol=0,
                                   atol=1e-4 * float(dense.u.abs().max()))
