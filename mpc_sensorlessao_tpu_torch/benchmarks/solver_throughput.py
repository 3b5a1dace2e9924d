"""Pure QP-solver throughput: batched fastMPC solves/s, no optics (port of
the repository's ``benchmarks/solver_throughput.py``).

The metric kernel of BASELINE.json ("aggregate MPC solves/s") alone: the
27-state / 144-input AO problem at the reference horizon, batched over
scenarios, through the constant-slack fixed-operator path
(newton_kkt.solve_fixed with precompute_fixed_newton) and the general
structured path (newton_kkt.solve, one Newton step).  The problem is the
JAX script's, from numpy seed 0, in float32.  Each path runs once to
warm up, then the best of 5 runs by the host clock, each ending in a
device synchronize.

Usage: python -m mpc_sensorlessao_tpu_torch.benchmarks.solver_throughput
       [batch] [horizon] [nx]
Env:   ST_DEVICE=cuda (the card unless "cpu" is named)
Prints one line a path and returns {path: {solves_per_s, us_per_solve}}.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np
import torch

from ..models import solvers
from ..ops import newton_kkt
from . import _protocol as P

N_INPUTS = 144


def problem(rng: np.random.Generator, nx: int,
            dev) -> newton_kkt.FastMPCProblem:
    """The benchmark's float32 fastMPC problem: A1 = 0.9 I + noise, A2 =
    -0.3 I + noise, B random (nx, 144), the reference's weights."""
    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)
    A1 = f32(0.9 * np.eye(nx) + 0.05 * rng.normal(size=(nx, nx)))
    A2 = f32(-0.3 * np.eye(nx) + 0.02 * rng.normal(size=(nx, nx)))
    B = f32(rng.normal(size=(nx, N_INPUTS)) * 0.3)
    return solvers.make_fastmpc_problem(
        A1, A2, B, q_weight=1.5e4, p_weight=1.5e4, r_weight=1.0,
        u_max=28.0, barrier_k=1e-2)


def states(rng: np.random.Generator, batch: int, nx: int, T: int, dev):
    """x0, x0_pre (batch, nx) and the disturbance w (batch, T * nx)."""
    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)
    return (f32(rng.normal(size=(batch, nx))),
            f32(rng.normal(size=(batch, nx))),
            f32(rng.normal(size=(batch, T * nx)) * 0.1))


def best_s(fn, dev, repeats: int) -> float:
    """One warm-up call, then the least host-clock seconds of ``repeats``
    calls, each ending in a device synchronize."""
    fn()
    P.sync(dev)
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        P.sync(dev)
        best = min(best, time.perf_counter() - t0)
    return best


def paths(prob: newton_kkt.FastMPCProblem, T: int, x0, x0p, w) -> dict:
    """The two solve paths on the batch: name -> argless call giving U."""
    op = newton_kkt.precompute_fixed_newton(prob, T)
    return {
        "fixed_op": lambda: newton_kkt.solve_fixed(prob, op, x0, x0p, w,
                                                   horizon=T).U,
        "structured": lambda: newton_kkt.solve(prob, x0, x0p, w, horizon=T,
                                               n_newton=1).U,
    }


def main(argv=None, env=None) -> dict:
    argv = sys.argv[1:] if argv is None else list(argv)
    env = os.environ if env is None else env
    batch = int(argv[0]) if argv else 4096
    T = int(argv[1]) if len(argv) > 1 else 2
    nx = int(argv[2]) if len(argv) > 2 else 27
    dev = P.device(env, "ST_DEVICE")
    rng = np.random.default_rng(0)
    prob = problem(rng, nx, dev)
    report = {}
    for name, fn in paths(prob, T, *states(rng, batch, nx, T, dev)).items():
        best = best_s(fn, dev, 5)
        report[name] = {"solves_per_s": batch / best,
                        "us_per_solve": best * 1e6 / batch}
        print(f"{name:12s} batch={batch} T={T} nx={nx}: "
              f"{batch / best:,.0f} solves/s ({best*1e6/batch:.2f} us/solve)"
              f" [{P.device_name(dev)}]")
    return report


if __name__ == "__main__":
    main()
