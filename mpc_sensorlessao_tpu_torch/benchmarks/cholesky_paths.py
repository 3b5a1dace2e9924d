"""Batched small-matrix factorization micro-benchmark (port of the
repository's ``benchmarks/cholesky_paths.py``).

Times the pieces that decide whether a hand-written batched Cholesky
would pay for the general (n_newton > 1) solver path:

  raw-chol:    batched torch.linalg.cholesky + cholesky_solve of
               (B, Tn, Tn) SPD systems (what every extra Newton
               iteration costs)
  inv-matmul:  a precomputed inverse applied as one batched matmul (the
               fixed-operator real-time path's shape)
  newton x1/2: end-to-end structured solves (newton_kkt.solve) at
               n_newton = 1 / 2

If raw-chol is within ~2x of inv-matmul's cost, the library's batched
Cholesky is fine; a >>2x gap is the signal to write a kernel.  The
systems are the JAX script's, from numpy seed 0, float32; each timing is
solver_throughput.best_s over 5 runs.

Usage: python -m mpc_sensorlessao_tpu_torch.benchmarks.cholesky_paths
       [batch] [nx] [horizon]
Env:   CP_DEVICE=cuda (the card unless "cpu" is named)
Prints one line a path and returns {path: {per_s, us_each}}.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

from ..models import solvers
from ..ops import newton_kkt
from . import _protocol as P
from .solver_throughput import N_INPUTS, best_s, states


def systems(rng: np.random.Generator, batch: int, d: int):
    """(B, d, d) SPD systems L L' + 3 I and right-hand sides (B, d),
    float64 host arrays."""
    L = rng.normal(size=(batch, d, d)) * 0.1
    S = np.einsum("bij,bkj->bik", L, L) + 3.0 * np.eye(d)
    return S, rng.normal(size=(batch, d))


def chol_solve(S: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.cholesky_solve(b[..., None],
                                torch.linalg.cholesky(S))[..., 0]


def paths(rng: np.random.Generator, batch: int, nx: int, T: int,
          dev) -> dict:
    """label -> (argless call, count of solves), in the JAX script's
    order of draws."""
    d = T * nx
    S, b = systems(rng, batch, d)
    Sj = torch.as_tensor(S, dtype=torch.float32, device=dev)
    bj = torch.as_tensor(b, dtype=torch.float32, device=dev)
    Sinv = torch.as_tensor(np.linalg.inv(S[0]), dtype=torch.float32,
                           device=dev)
    out = {f"raw-chol    (B={batch}, d={d})": lambda: chol_solve(Sj, bj),
           f"inv-matmul  (B={batch}, d={d})": lambda: bj @ Sinv.T}

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)
    A1 = f32(0.9 * np.eye(nx) + 0.05 * rng.normal(size=(nx, nx)))
    A2 = f32(-0.3 * np.eye(nx))
    B = f32(rng.normal(size=(nx, N_INPUTS)) * 0.3)
    prob = solvers.make_fastmpc_problem(
        A1, A2, B, q_weight=1.5e4, p_weight=1.5e4, r_weight=1.0,
        u_max=28.0, barrier_k=1e-2)
    x0, x0p, w = states(rng, batch, nx, T, dev)
    for nn in (1, 2):
        out[f"newton x{nn}   (B={batch}, T={T})"] = (
            lambda nn=nn: newton_kkt.solve(prob, x0, x0p, w, horizon=T,
                                           n_newton=nn).U)
    return out


def main(argv=None, env=None) -> dict:
    argv = sys.argv[1:] if argv is None else list(argv)
    env = os.environ if env is None else env
    batch = int(argv[0]) if argv else 4096
    nx = int(argv[1]) if len(argv) > 1 else 27
    T = int(argv[2]) if len(argv) > 2 else 2
    dev = P.device(env, "CP_DEVICE")
    report = {}
    for label, fn in paths(np.random.default_rng(0), batch, nx, T,
                           dev).items():
        t = best_s(fn, dev, 5)
        report[label.split("(")[0].strip()] = {"per_s": batch / t,
                                               "us_each": t * 1e6 / batch}
        print(f"{label}: {batch / t:12,.0f}/s ({t * 1e6 / batch:7.2f} us "
              f"each) [{P.device_name(dev)}]")
    return report


if __name__ == "__main__":
    main()
