"""Long-horizon solver scaling: dense Schur Cholesky against block cyclic
reduction (ops/block_tridiag.py) (port of the repository's
``benchmarks/long_horizon.py``).

The reference's dense factorization (inf_newton_solver.m:24-31) is
O(T^3 n^3); cyclic reduction is O(T n^3) work at O(log T) depth.  This
sweeps the horizon at a fixed batch and reports solves/s of the general
structured Newton solve (newton_kkt.solve, one Newton step) with each
Schur backend, chosen by newton_kkt.CR_MIN_HORIZON (set for the call
and restored after it).  The problem is solver_throughput's, from numpy
seed 0, float32; each timing is solver_throughput.best_s over 3 runs.

Usage: python -m mpc_sensorlessao_tpu_torch.benchmarks.long_horizon
       [batch] [nx] [T1,T2,...]
Env:   LH_DEVICE=cuda (the card unless "cpu" is named)
Prints one line a (horizon, backend) and returns {"T=<T> <backend>":
{solves_per_s, us_per_solve}}.
"""

from __future__ import annotations

import contextlib
import os
import sys

import numpy as np

from ..ops import newton_kkt
from . import _protocol as P
from .solver_throughput import best_s, problem, states

BACKENDS = (("cyclic-red", 1), ("dense-chol", 10 ** 6))


@contextlib.contextmanager
def cr_from(horizon: int):
    """Within the block, the general solve takes cyclic reduction from
    ``horizon`` on (newton_kkt.CR_MIN_HORIZON)."""
    saved = newton_kkt.CR_MIN_HORIZON
    newton_kkt.CR_MIN_HORIZON = horizon
    try:
        yield
    finally:
        newton_kkt.CR_MIN_HORIZON = saved


def solve(prob, T: int, x0, x0p, w):
    return newton_kkt.solve(prob, x0, x0p, w, horizon=T, n_newton=1).U


def main(argv=None, env=None) -> dict:
    argv = sys.argv[1:] if argv is None else list(argv)
    env = os.environ if env is None else env
    batch = int(argv[0]) if argv else 256
    nx = int(argv[1]) if len(argv) > 1 else 27
    Ts = ([int(t) for t in argv[2].split(",")] if len(argv) > 2
          else [8, 16, 32, 64, 128])
    dev = P.device(env, "LH_DEVICE")
    rng = np.random.default_rng(0)
    prob = problem(rng, nx, dev)
    report = {}
    for T in Ts:
        args = states(rng, batch, nx, T, dev)
        for name, thr in BACKENDS:
            with cr_from(thr):
                dt = best_s(lambda: solve(prob, T, *args), dev, 3)
            report[f"T={T} {name}"] = {"solves_per_s": batch / dt,
                                       "us_per_solve": dt * 1e6 / batch}
            print(f"T={T:4d} {name}: {batch / dt:10,.0f} solves/s "
                  f"({dt * 1e6 / batch:8.1f} us/solve) "
                  f"[{P.device_name(dev)}]")
    return report


if __name__ == "__main__":
    main()
