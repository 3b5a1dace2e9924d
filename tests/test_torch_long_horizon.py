"""The port's long-horizon one-step fastMPC against the benchmark's plain
float64 reference (``ao_bench/reference``), on the CPU.

The benchmark's ``modes14n32`` configuration runs the fixed Newton step
at horizon N=32 over 119 states, with the VAR companion-radius clamp.
These tests hold the pieces it adds to the main path at small widths:

- ``newton_kkt.solve_fixed`` (the precomputed S^-1 of the dual Schur
  complement, then the 16-candidate line search) against
  ``control.FastMPC.solve`` (the dense KKT inverse of the whole horizon,
  then the sequential backtracking), first-stage U, at N = 2, 16, 32;
- the line search's bank scored from the residuals' affine structure
  (``line_search_terms`` + ``line_search_bank_ref``, the plain version of
  kernel L1) against the full residuals of the 16 candidate states, at
  N = 2, 16, 32, and the ramp rows' evaluation left as it was;
- ``var.stabilize`` against ``control.var_stabilise``;
- the benchmark cell itself, cut to R=32, radial order 6 and N=16,
  through ``harness.run`` (``correct`` decided against the reference).
"""

import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from ao_bench.reference import control  # noqa: E402
from mpc_sensorlessao_tpu_torch.models import solvers, var  # noqa: E402
from mpc_sensorlessao_tpu_torch.ops import newton_kkt  # noqa: E402
from mpc_sensorlessao_tpu_torch.utils import tree  # noqa: E402

torch.set_num_threads(1)

F64 = torch.float64
MPC = {"q_weight": 15000.0, "p_weight_scale": 1.0, "r_weight": 30.0,
       "u_max": 28.0, "barrier_k": 0.01}


def stable_var2(rng, nx, radius=0.9):
    """A seeded VAR(2) pair, lag j shrunk by gamma^j so that its
    companion radius is at most ``radius``."""
    A1 = 0.6 * np.eye(nx) + 0.08 * rng.normal(size=(nx, nx))
    A2 = 0.25 * np.eye(nx) + 0.05 * rng.normal(size=(nx, nx))
    comp = np.block([[A1, A2], [np.eye(nx), np.zeros((nx, nx))]])
    g = min(1.0, radius / np.abs(np.linalg.eigvals(comp)).max())
    return torch.as_tensor(g * A1), torch.as_tensor(g * g * A2)


def problem(seed, nx=14, nu=16, horizon=2):
    rng = np.random.default_rng(seed)
    A1, A2 = stable_var2(rng, nx)
    B = torch.as_tensor(0.4 * rng.normal(size=(nx, nu)))
    ref = control.FastMPC(A1, A2, B, dict(MPC, horizon=horizon))
    prob = solvers.make_fastmpc_problem(
        A1, A2, B, q_weight=MPC["q_weight"],
        p_weight=MPC["p_weight_scale"] * MPC["q_weight"],
        r_weight=MPC["r_weight"], u_max=MPC["u_max"],
        barrier_k=MPC["barrier_k"])
    # scenarios from well inside the box to far past it, so that the
    # line search takes the full step in some and backtracks in others
    scale = torch.as_tensor(np.repeat([0.01, 0.1, 1.0, 10.0], 8))[:, None]
    x0 = scale * torch.as_tensor(rng.normal(size=(32, nx)))
    x_pre = scale * torch.as_tensor(rng.normal(size=(32, nx)))
    w = scale * torch.as_tensor(rng.normal(size=(32, horizon * nx)))
    return prob, ref, x0, x_pre, w


# float64: the two solves are the same arithmetic up to rounding, so the
# first-stage U agrees to 1e-10 of its scenario's largest entry (read:
# <= 1.0e-14 at N = 2, 16, 32).  float32: the loop's own precision -- the
# problem and S^-1 rounded to float32 once, as
# closed_loop.make_loop_models does -- within 1e-4 of the float64
# reference (read: 2.1e-6, 2.2e-6, 3.7e-6 at N = 2, 16, 32); a step
# length that differed between the two would move U by half of it.
@pytest.mark.parametrize("dtype,rtol", [(F64, 1e-10), (torch.float32, 1e-4)],
                         ids=["float64", "float32"])
@pytest.mark.parametrize("horizon", [2, 16, 32])
def test_solve_fixed_matches_the_reference_dense_kkt(horizon, dtype, rtol):
    prob, ref, x0, x_pre, w = problem(horizon, horizon=horizon)
    op = newton_kkt.precompute_fixed_newton(prob, horizon)
    prob_c, op_c = tree.cast(prob, dtype), tree.cast(op, dtype)
    got = newton_kkt.solve_fixed(prob_c, op_c, x0.to(dtype),
                                 x_pre.to(dtype), w.to(dtype), horizon)
    nu = prob.B.shape[1]
    want = ref.solve(w, x0, x_pre)[:, :nu]
    scale = want.abs().amax(dim=-1, keepdim=True)
    # the line search takes the full Newton step in some scenarios and
    # backtracks in others
    full = (ref.rhs(w, x0, x_pre) @ ref.kkt_b.T)[:, ref.iu][:, :nu]
    backtracked = ((full - want).abs() / scale).amax(dim=-1) > 1e-6
    assert bool(backtracked.any()) and not bool(backtracked.all())
    u = got.U[:, 0].to(F64)
    assert float(((u - want).abs() / scale).max()) < rtol


def full_bank(prob, b, state, direction, ramp=False):
    """The bank as the line search scored it before the affine path: the
    16 candidate states as (..., 16, T, .) tensors through the full
    ``residuals``; returns (t = 0's norm, the 16 norms, accepted mask)."""
    dU, dX, dnu = direction
    base = newton_kkt.residual_norm(*newton_kkt.residuals(prob, b, state,
                                                          ramp=ramp))
    ts = newton_kkt.LS_BETA ** torch.arange(newton_kkt.LS_CANDIDATES,
                                            dtype=dU.dtype)
    tc = ts[:, None, None]

    def at(x, dx):
        return x.unsqueeze(-3) + tc * dx.unsqueeze(-3)

    cand = newton_kkt.SolverState(at(state.U, dU), at(state.X, dX),
                                  at(state.nu, dnu))
    cprob = (dataclasses.replace(prob, u_prev=prob.u_prev.unsqueeze(-2))
             if ramp else prob)
    norm = newton_kkt.residual_norm(*newton_kkt.residuals(
        cprob, b.unsqueeze(-3), cand, ramp=ramp))
    ok = ((cand.U < prob.u_max).all(dim=(-2, -1))
          & (cand.U > prob.u_min).all(dim=(-2, -1)))
    if ramp:
        r_hi, r_lo = newton_kkt._ramp_slacks(cprob, cand.U)
        ok = ok & (r_hi > 0).all(dim=(-2, -1)) & (r_lo > 0).all(dim=(-2, -1))
    ok = ok & (norm <= (1.0 - newton_kkt.LS_ALPHA * ts) * base[..., None])
    return base, norm, ok


def fixed_step(horizon, dtype):
    """The first line search of ``solve_fixed`` on ``problem``'s
    scenarios: (problem, b, state, direction) in ``dtype``."""
    prob, _, x0, x_pre, w = problem(horizon, horizon=horizon)
    op = newton_kkt.precompute_fixed_newton(prob, horizon)
    prob, op = tree.cast(prob, dtype), tree.cast(op, dtype)
    b = newton_kkt.equality_rhs(prob, x0.to(dtype), x_pre.to(dtype),
                                w.to(dtype), horizon)
    return (prob, b, newton_kkt.init_state(prob, horizon),
            newton_kkt.fixed_newton_direction(prob, op, b))


# The affine evaluation rounds otherwise than the candidates' full
# residuals.  Each of the 17 norms is held to the full evaluation's within
# a share of the scenario's t = 0 norm, the scale of the decrease rule.
# A share of each norm's own value would not hold: at t = 1 the Newton
# step cancels rp and rd_x down to their rounding (own-value gaps read
# 1.1e-4 in float64, 6.8e-2 in float32).  float64: 1e-12 (read: <=
# 8.1e-15).  float32: each of the two evaluations sits 1.4e-5 to 6.0e-5
# of t = 0's norm from the float64 evaluation of the same float32 data,
# so they may differ by the sum; held to 4e-5 (read: 1.28e-5, 3.4e-6,
# 6.3e-6 at N = 2, 16, 32), and the affine one to no more than 1.1 times
# the full one's distance from float64 (read: 0.84, 0.92, 0.96 times).
@pytest.mark.parametrize("dtype,rtol", [(F64, 1e-12), (torch.float32, 4e-5)],
                         ids=["float64", "float32"])
@pytest.mark.parametrize("horizon", [2, 16, 32])
def test_affine_bank_matches_the_full_residuals(horizon, dtype, rtol):
    prob, b, state, direction = fixed_step(horizon, dtype)
    terms = newton_kkt.line_search_terms(prob, b, state, direction)
    # kernel L1's layout: every vector (B, T, .) and contiguous, the
    # state's too, though at the midpoint start it is the same row for
    # every scenario
    B, T, (n, m) = b.shape[0], horizon, prob.B.shape
    assert [tuple(v.shape) for v in terms] == [(B, T, m)] * 4 + [(B, T, n)] * 4
    assert all(v.is_contiguous() for v in terms)
    idx, t, norms = newton_kkt.line_search_bank_ref(
        *terms, prob.u_min, prob.u_max, prob.barrier_k)
    base, norm, ok = full_bank(prob, b, state, direction)
    want = torch.where(ok.any(dim=-1), torch.argmax(ok.to(torch.int8), dim=-1),
                       newton_kkt.LS_CANDIDATES - 1)
    assert torch.equal(idx, want)
    # the full step in some scenarios, a backtrack in others
    assert bool((idx == 0).any()) and bool((idx > 0).any())
    assert torch.equal(t, newton_kkt.LS_BETA ** want.to(dtype))
    full = torch.cat([base[:, None], norm], dim=-1)
    gap = ((norms - full).abs() / base[:, None]).max()
    assert float(gap) <= rtol
    if dtype == torch.float32:
        wide = newton_kkt.SolverState(*(v.to(F64) for v in state))
        base64, norm64, _ = full_bank(
            tree.cast(prob, F64), b.to(F64), wide,
            tuple(v.to(F64) for v in direction))
        exact = torch.cat([base64[:, None], norm64], dim=-1)

        def off(v):
            return float(((v.to(F64) - exact).abs() / base64[:, None]).max())

        assert off(norms) <= 1.1 * off(full)
    got = newton_kkt.line_search_step(prob, b, state, direction)
    for v, dv, g in zip(state, direction, got):
        torch.testing.assert_close(g, v + t[:, None, None] * dv,
                                   rtol=4 * torch.finfo(dtype).eps, atol=0.0)


def test_affine_bank_falls_back_to_the_smallest_step():
    """A direction that leaves the box at every t of the bank takes the
    smallest step, index 15."""
    prob, b, state, (dU, dX, dnu) = fixed_step(2, torch.float32)
    dU = dU.clone()
    dU[:3, 0, 0] = 1e9
    terms = newton_kkt.line_search_terms(prob, b, state, (dU, dX, dnu))
    idx, t, _ = newton_kkt.line_search_bank_ref(
        *terms, prob.u_min, prob.u_max, prob.barrier_k)
    assert idx[:3].tolist() == [newton_kkt.LS_CANDIDATES - 1] * 3
    assert t[:3].tolist() == [0.5 ** 15] * 3
    _, _, ok = full_bank(prob, b, state, (dU, dX, dnu))
    assert not bool(ok[:3].any())


def test_ramp_line_search_is_the_full_evaluation():
    """With ramp rows the line search still scores the full residuals
    of the 16 candidates: its step is the helper's, bit for bit."""
    prob, b, _, _ = fixed_step(16, torch.float32)
    B = b.shape[0]
    m = prob.u_min.shape[-1]
    rng = np.random.default_rng(7)
    prob = dataclasses.replace(
        prob, du_min=torch.full((m,), -4.0), du_max=torch.full((m,), 4.0),
        u_prev=torch.as_tensor(rng.uniform(-6, 6, size=(B, m)),
                               dtype=torch.float32))
    state = newton_kkt.init_state(prob, 16, ramp=True)
    direction = newton_kkt.newton_direction(prob, b, state, ramp=True)
    got = newton_kkt.line_search_step(prob, b, state, direction, ramp=True)
    _, _, ok = full_bank(prob, b, state, direction, ramp=True)
    ts = newton_kkt.LS_BETA ** torch.arange(newton_kkt.LS_CANDIDATES,
                                            dtype=torch.float32)
    idx = torch.argmax(ok.to(torch.int8), dim=-1)
    t = torch.where(ok.any(dim=-1), ts[idx], ts[-1])[:, None, None]
    assert bool((idx > 0).any())
    for v, dv, g in zip(state, direction, got):
        assert torch.equal(g, v + t * dv)


@pytest.mark.parametrize("order", [1, 2])
def test_var_stabilize_matches_the_reference_clamp(order):
    """Above the clamp both shrink lag j by (r_max / rho)^j; below it
    both hand the fit back unchanged."""
    rng = np.random.default_rng(order)
    nx = 10
    A = torch.as_tensor(np.stack(
        [0.7 * np.eye(nx) + 0.1 * rng.normal(size=(nx, nx))]
        + [0.29 * np.eye(nx)] * (order - 1)))
    model = var.VARModel(A=A, order=order)
    rho = var.companion_spectral_radius(model)
    assert rho > 0.85
    for radius in (0.85, rho + 0.01):
        got = var.stabilize(model, radius).A
        want = control.var_stabilise(list(A), radius)
        torch.testing.assert_close(got, torch.stack(want), rtol=1e-12,
                                   atol=0.0)
    assert var.companion_spectral_radius(
        var.VARModel(A=var.stabilize(model, 0.85).A, order=order)) \
        == pytest.approx(0.85, rel=1e-9)


# The cell run in a process of its own: the harness refuses a run in
# which JAX is loaded, and the test suite's conftest loads it.
CUT_CELL = """
import json, sys, time, torch
torch.set_num_threads(1)
from ao_bench import harness
cell = harness.Cell("modes14n32.shared")
cell.rehearse()
cfg = cell.config
for group in ("telescope", "estimator"):
    cfg[group]["resolution"] = 32
cfg["zernike"]["radial_order"] = 6
cfg["mpc"]["horizon"] = 16
res = harness.run(cell, 2 ** 31 + 5, 0.1, False, torch.device("cpu"),
                  time.perf_counter(), log=lambda _: None)
print(json.dumps(res))
"""


def test_modes14n32_cell_cut_is_correct_on_the_cpu():
    """The configuration's path -- MMSE at order 6 here, the ridge VAR
    with the radius clamp, warm start, the N=16 fixed Newton step --
    through ``harness.run``, with ``correct`` decided by the float64
    reference at the rehearsal's limits."""
    proc = subprocess.run([sys.executable, "-c", CUT_CELL], cwd=ROOT,
                          capture_output=True, text=True, timeout=600,
                          env={"PATH": "/usr/bin:/bin",
                               "PYTHONPATH": str(ROOT),
                               "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stderr[-3000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["correct"] is True, res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
