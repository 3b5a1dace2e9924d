"""The port's scenario-parallel runner, tensor-parallel estimator and
horizon-parallel solve (ROADMAP A.10) over four real gloo ranks on the
CPU, held to the JAX package's parallel/ (8-device CPU mesh) and to
single-process and dense references.

One world of four spawned ranks runs every multi-rank check
(tests/torch_parallel_support.parallel_checks, jax-free); the test
process builds and carries the systems across beforehand, saves them
with the port's utils.checkpoint, and holds what the ranks return.
Config: tests/test_parallel.py's R=32 tiny system.  Tolerances: the JAX
tests' -- statistics rtol 1e-4 against the same reduction of run_batch;
TP rtol 2e-4 (estimate) and 5e-4 (normal equations); the horizon solve
rtol 2e-4 at J=32 and 5e-4 at J = 3P, 5P; against the JAX run_sharded,
equal counts and the means to tests/test_torch_loop.py's
_assert_trajectory tolerance (rtol 0.01, atol 5e-3).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_sensorlessao_tpu.models import pipeline as jpipeline
from mpc_sensorlessao_tpu.parallel import estimator_tp as jtp
from mpc_sensorlessao_tpu.parallel import horizon as jhorizon
from mpc_sensorlessao_tpu.parallel import mesh as jmesh
from mpc_sensorlessao_tpu.parallel import montecarlo as jmontecarlo
from mpc_sensorlessao_tpu.utils import config as jconfig
from mpc_sensorlessao_tpu_torch import interop
from mpc_sensorlessao_tpu_torch.models import pipeline
from mpc_sensorlessao_tpu_torch.ops import block_tridiag
from mpc_sensorlessao_tpu_torch.parallel import dryrun, mesh, montecarlo
from mpc_sensorlessao_tpu_torch.utils import checkpoint

import torch_parallel_support as support

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False

MEANS = ("mean_rms_res", "mean_rms_turb", "mean_strehl",
         "mean_strehl_exact")


def _jax_small_cfg():
    cfg = jconfig.reference_config(resolution=32)
    return cfg.replace(
        sim=dataclasses.replace(cfg.sim, n_train=150, n_valid=20, n_test=30),
        estimator=dataclasses.replace(cfg.estimator, resolution=32,
                                      crop_half=7),
        dm=dataclasses.replace(cfg.dm, n_act_side=8),
        zernike=dataclasses.replace(cfg.zernike, radial_order=4),
    )


@pytest.fixture(scope="module")
def systems():
    cfg = dryrun.small_cfg()
    port = pipeline.build(cfg, "cpu")
    jcfg = _jax_small_cfg()
    jsys = jpipeline.build(jcfg, jax.random.PRNGKey(0))
    return cfg, port, jcfg, jsys


@pytest.fixture(scope="module")
def carried_scen(systems):
    """16 scenarios over D/r0 and the shared test window, noise 0: the
    JAX batch (its keys unused) and the same numbers for the ranks."""
    _, _, jcfg, _ = systems
    scen = jmontecarlo.make_scenarios(jcfg, jax.random.PRNGKey(4),
                                      support.N_SCEN,
                                      d_over_r0_grid=(2.0, 5.0, 10.0))
    scen = scen._replace(noise_scale=jnp.zeros_like(scen.noise_scale))
    return scen, {k: np.asarray(getattr(scen, k))
                  for k in ("start_step", "mag", "noise_scale")}


@pytest.fixture(scope="module")
def ranks(systems, carried_scen, tmp_path_factory):
    """The four ranks' results of torch_parallel_support.parallel_checks."""
    cfg, port, _, jsys = systems
    tmp = tmp_path_factory.mktemp("parallel")
    port_dir, carried_dir = str(tmp / "port"), str(tmp / "carried")
    checkpoint.save(port_dir, {"loop": port.loop, "layers": port.layers,
                               "cfg": cfg})
    checkpoint.save(carried_dir, {
        "loop": interop.loop_models_from_numpy(
            jax.tree.map(np.asarray, jsys.loop), "cpu"),
        "layers": interop.layers_from_numpy(
            jax.tree.map(np.asarray, jsys.layers), "cpu"),
        "cfg": cfg})
    return support.spawn_cpu(support.parallel_checks, port_dir,
                             carried_dir, carried_scen[1])


def _same_on_every_rank(ranks, key):
    for r in ranks[1:]:
        assert r[key] == ranks[0][key]
    return ranks[0][key]


def test_mesh_helpers():
    assert mesh.pad_to_devices(13, 8) == 16
    assert mesh.pad_to_devices(16, 4) == 16


def test_sharded_stats_match_run_batch(systems, ranks):
    """Four ranks' statistics equal run_batch's over the same 16
    scenarios on one process (the same reduction, rtol 1e-4), and the
    settled residual and Marechal Strehl means of the JAX test's
    definition (tests/test_parallel.py)."""
    cfg, port, _, _ = systems
    stats = _same_on_every_rank(ranks, "stats")
    assert stats["n_scenarios"] == support.N_SCEN
    scen = montecarlo.make_scenarios(cfg, torch.Generator().manual_seed(2),
                                     support.N_SCEN, device="cpu")
    out = montecarlo.run_batch(port.loop, port.layers, cfg, scen,
                               support.STEPS)
    one = montecarlo.reduce_stats(out, support.STEPS)
    for k in MEANS + ("max_rms_res", "mean_cost"):
        np.testing.assert_allclose(stats[k], float(getattr(one, k)),
                                   rtol=1e-4, err_msg=k)
    settle = montecarlo._settled_slice(support.STEPS)
    np.testing.assert_allclose(stats["mean_rms_res"],
                               float(out.rms_res[:, settle:].mean()),
                               rtol=1e-4)
    np.testing.assert_allclose(stats["mean_strehl"],
                               float(out.strehl[:, settle:].mean()),
                               rtol=1e-4)


def test_sharded_stats_contain_diverged_scenarios(ranks):
    """A poisoned scenario (NaN magnification -> NaN telemetry) is counted
    in n_diverged and kept out of the means (tests/test_parallel.py)."""
    stats = _same_on_every_rank(ranks, "poisoned")
    n = 2 * support.WORLD
    assert stats["n_diverged"] >= 1
    assert stats["n_scenarios"] + stats["n_diverged"] == n
    assert np.isfinite(stats["mean_rms_res"])
    assert stats["mean_rms_res"] < 10.0


@pytest.mark.parametrize("case,match", [
    ("refused_window", "distinct start_steps"),
    ("refused_edge_state", "unbatched"),
    ("refused_uneven", "multiple"),
    ("refused_horizon", "J % P"),
])
def test_sharded_runner_refusals(ranks, case, match):
    """The runner refuses a shared window over distinct windows, a
    batched edge_state (JAX montecarlo.py:323-329) and a batch that does
    not split over the ranks (:385); the horizon solve a J that does not
    split in chunks of 3 or more -- on every rank, before any
    collective."""
    for r in ranks:
        assert match in r[case], (case, r[case])


def test_rank_local_scenario_rows(ranks):
    """Each rank runs its contiguous rows of the global batch; together
    they cover it once (the counterpart of the JAX
    test_multihost_global_scenario_assembly), and the sharded run of 2
    scenarios a rank counts all of them."""
    n = 2 * support.WORLD
    assert [r["rows"] for r in ranks] == [[2 * k, 2 * k + 2]
                                          for k in range(support.WORLD)]
    stats = _same_on_every_rank(ranks, "assembled")
    assert stats["n_scenarios"] == n
    assert np.isfinite(stats["mean_rms_res"])


def test_sharded_stats_match_jax_run_sharded(systems, carried_scen, ranks):
    """The port's four-rank run_sharded on the carried JAX operators
    against the JAX run_sharded on the 8-device CPU mesh, the same 16
    scenarios with noise_scale 0: equal counts, means within
    _assert_trajectory's tolerance."""
    _, _, jcfg, jsys = systems
    jstats = jmontecarlo.run_sharded(jsys.loop, jsys.layers, jcfg,
                                     carried_scen[0], n_steps=support.STEPS,
                                     mesh=jmesh.scenario_mesh())
    stats = _same_on_every_rank(ranks, "carried")
    assert stats["n_scenarios"] == float(jstats.n_scenarios)
    assert stats["n_diverged"] == float(jstats.n_diverged)
    for k in MEANS + ("max_rms_res",):
        np.testing.assert_allclose(stats[k], float(getattr(jstats, k)),
                                   rtol=0.01, atol=5e-3, err_msg=k)


def test_tensor_parallel_matches_jax_and_dense(ranks):
    """The pixel-sharded estimate and normal equations at nx=27, p=2883
    (p % 4 != 0: the padding path) against the dense products and the
    JAX estimator_tp on the 8-device mesh (tests/test_parallel.py)."""
    S, b, y, A, yr = support.tp_arrays()
    m = jtp.tp_mesh()
    j_est = np.asarray(jtp.sharded_estimate(S, b, y, m))
    jG, jg = (np.asarray(a) for a in jtp.sharded_normal_equations(A, yr, m))
    ref = (y - b) @ S.T
    for r in ranks:
        est = r["tp_estimate"].numpy()
        for want in (ref, j_est):
            np.testing.assert_allclose(est, want, rtol=2e-4, atol=2e-4)
        for got, want in ((r["tp_gram"].numpy(), (A.T @ A, jG)),
                          (r["tp_grad"].numpy(), (yr @ A, jg))):
            for w in want:
                np.testing.assert_allclose(got, w, rtol=5e-4, atol=5e-3)


def _dense(diag, sub):
    J, n, _ = diag.shape
    S = np.zeros((J * n, J * n))
    for j in range(J):
        S[j*n:(j+1)*n, j*n:(j+1)*n] = diag[j]
        if j > 0:
            S[j*n:(j+1)*n, (j-1)*n:j*n] = sub[j]
            S[(j-1)*n:j*n, j*n:(j+1)*n] = sub[j].T
    return S


@pytest.mark.parametrize("case", range(len(support.HZ_CASES)))
def test_horizon_matches_jax_dense_and_cr_solve(ranks, case):
    """solve_distributed over 4 ranks (each its J/4 rows) against the
    dense solve, the single-device cyclic reduction and the JAX
    solve_distributed on a 4-device mesh, at J=32, n=5 and J = 3P, 5P
    (tests/test_horizon.py)."""
    J, n, seed = support.HZ_CASES[case]
    diag, sub, rhs = support.spd_tridiag(J, n, seed)
    x = np.concatenate([r["horizon"][case].numpy() for r in ranks])
    assert x.shape == (J, n)
    rtol = 2e-4 if J == 32 else 5e-4
    dense = np.linalg.solve(_dense(diag, sub),
                            rhs.reshape(-1)).reshape(J, n)
    cr = block_tridiag.cr_solve(*(torch.as_tensor(a)
                                  for a in (diag, sub, rhs))).numpy()
    jx = np.asarray(jhorizon.solve_distributed(
        jnp.asarray(diag), jnp.asarray(sub), jnp.asarray(rhs),
        jhorizon.hz_mesh(support.WORLD)))
    for want in (dense, cr, jx):
        np.testing.assert_allclose(x, want, rtol=rtol, atol=rtol)
