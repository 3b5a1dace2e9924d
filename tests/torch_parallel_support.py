"""Rank functions of the port's multi-process tests
(tests/test_torch_parallel.py), spawned with
``parallel.multihost.spawn``.

This module imports no jax: a spawned rank imports it by name, and the
ranks run the port only.  The test process builds (or carries across
from the JAX package) the systems, saves them with ``utils.checkpoint``,
and compares what the ranks return with the JAX package and with
single-process runs.
"""

import contextlib
import os

import numpy as np
import torch

from mpc_sensorlessao_tpu_torch.ops import edge_flow
from mpc_sensorlessao_tpu_torch.parallel import estimator_tp, horizon
from mpc_sensorlessao_tpu_torch.parallel import mesh as mesh_lib
from mpc_sensorlessao_tpu_torch.parallel import montecarlo, multihost
from mpc_sensorlessao_tpu_torch.utils import checkpoint

WORLD = 4
STEPS = 8
N_SCEN = 16             # the sharded-vs-run_batch batch
TP_SHAPE = (27, 2883, 5)        # nx, p, B: p % 4 != 0 takes the padding
HZ_CASES = ((32, 5, 0), (WORLD * 3, 3, WORLD * 3), (WORLD * 5, 3, WORLD * 5))


@contextlib.contextmanager
def one_host_thread():
    """Ranks spawned inside get one host thread each (the suite runs
    several test files at once)."""
    saved = {k: os.environ.get(k) for k in multihost.THREAD_VARS}
    os.environ.update({k: "1" for k in multihost.THREAD_VARS})
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def spawn_cpu(fn, *args):
    """``fn`` on WORLD CPU ranks over gloo, one host thread each."""
    with one_host_thread():
        return multihost.spawn(fn, WORLD, device="cpu", args=args,
                               timeout=600.0)


def tp_arrays():
    """The inputs of the JAX tensor-parallel test (tests/test_parallel.py)."""
    rng = np.random.default_rng(0)
    nx, p, B = TP_SHAPE
    S = rng.normal(size=(nx, p)).astype(np.float32)
    b = rng.normal(size=(p,)).astype(np.float32)
    y = rng.normal(size=(B, p)).astype(np.float32)
    A = rng.normal(size=(p, nx)).astype(np.float32)
    yr = rng.normal(size=(p,)).astype(np.float32)
    return S, b, y, A, yr


def spd_tridiag(J, n, seed=0):
    """A random diagonally dominant SPD block-tridiagonal system, float32
    (tests/test_horizon.py's)."""
    rng = np.random.default_rng(seed)
    sub = rng.normal(size=(J, n, n)) * 0.3
    sub[0] = 0.0
    diag = np.zeros((J, n, n))
    for j in range(J):
        a = rng.normal(size=(n, n)) * 0.3
        diag[j] = a @ a.T + (2.0 + 2 * n) * np.eye(n)
    rhs = rng.normal(size=(J, n))
    return (diag.astype(np.float32), sub.astype(np.float32),
            rhs.astype(np.float32))


def _refused(fn) -> str:
    try:
        fn()
    except ValueError as e:
        return str(e)
    return ""


def parallel_checks(rank, world, device, port_dir, carried_dir,
                    carried_scen) -> dict:
    """Every multi-rank check of tests/test_torch_parallel.py, in one
    world: what each rank computes, for the test process to hold."""
    port = checkpoint.restore(port_dir)
    loop, layers, cfg = port["loop"], port["layers"], port["cfg"]
    mesh = mesh_lib.scenario_mesh(device_type="cpu")
    out = {}

    # sharded statistics against run_batch's reduction
    scen = montecarlo.make_scenarios(cfg, torch.Generator().manual_seed(2),
                                     N_SCEN, device="cpu")
    out["stats"] = montecarlo.run_sharded(loop, layers, cfg, scen, STEPS,
                                          mesh).as_floats()

    # a poisoned scenario (non-finite magnification) is contained
    scen = montecarlo.make_scenarios(cfg, torch.Generator().manual_seed(1),
                                     2 * world, device="cpu")
    mag = scen.mag.clone()
    mag[0] = float("nan")
    out["poisoned"] = montecarlo.run_sharded(
        loop, layers, cfg, scen._replace(mag=mag), STEPS, mesh).as_floats()

    # the refusals: a shared window claimed over distinct windows, a
    # batched edge_state, a batch that does not split evenly
    distinct = montecarlo.make_scenarios(
        cfg, torch.Generator().manual_seed(3), 2 * world,
        start_range=(350, 360), device="cpu")
    out["refused_window"] = _refused(lambda: montecarlo.run_sharded(
        loop, layers, cfg, distinct, STEPS, mesh, shared_window=True))
    out["refused_edge_state"] = _refused(
        lambda: montecarlo.make_sharded_runner(
            loop, None, cfg, STEPS, mesh, edge_model=object(),
            edge_state=edge_flow.EdgeFlowState(
                phases=torch.zeros(2, 1, 4, 4))))
    out["refused_uneven"] = _refused(lambda: montecarlo.run_sharded(
        loop, layers, cfg, montecarlo.make_scenarios(
            cfg, torch.Generator().manual_seed(1), 2 * world + 1,
            device="cpu"), STEPS, mesh))

    # rank-local scenario rows, and the sharded run of 2 a rank
    rows = multihost.scenario_rows(2 * world, mesh)
    out["rows"] = [rows.start, rows.stop]
    scen = montecarlo.make_scenarios(cfg, torch.Generator().manual_seed(1),
                                     2 * world, device="cpu")
    out["assembled"] = montecarlo.run_sharded(loop, layers, cfg, scen, 6,
                                              mesh).as_floats()

    # the JAX operators carried across, noise_scale 0 (deterministic)
    carried = checkpoint.restore(carried_dir)
    out["carried"] = montecarlo.run_sharded(
        carried["loop"], carried["layers"], carried["cfg"],
        montecarlo.ScenarioBatch(
            start_step=torch.as_tensor(carried_scen["start_step"]),
            mag=torch.as_tensor(carried_scen["mag"]),
            noise_scale=torch.as_tensor(carried_scen["noise_scale"]),
            noise_seed=0), STEPS, mesh).as_floats()

    # tensor parallel: estimate and normal equations
    tp = estimator_tp.tp_mesh(device_type="cpu")
    S, b, y, A, yr = (torch.as_tensor(a) for a in tp_arrays())
    out["tp_estimate"] = estimator_tp.sharded_estimate(S, b, y, tp)
    out["tp_gram"], out["tp_grad"] = estimator_tp.sharded_normal_equations(
        A, yr, tp)

    # horizon parallel: this rank's rows of each solve
    hz = horizon.hz_mesh(device_type="cpu")
    out["horizon"] = [
        horizon.solve_distributed(*(torch.as_tensor(a) for a in
                                    spd_tridiag(J, n, seed)), hz)
        for J, n, seed in HZ_CASES]
    out["refused_horizon"] = _refused(lambda: horizon.solve_distributed(
        *(torch.as_tensor(a) for a in spd_tridiag(2 * world, 2)), hz))
    return out
