"""The port's B=1 latency and solver timers (mpc_sensorlessao_tpu_torch/
benchmarks/latency_b1.py, solver_throughput.py, long_horizon.py,
cholesky_paths.py) on the CPU at tiny sizes: their report schemas, and
the solves they time against the JAX solver paths the repository's
scripts time (``newton_kkt.solve_fixed`` / ``solve`` with each Schur
backend, ``cho_solve``) on the same numpy-seeded float32 problems under
``jax.vmap``, at tests/test_torch_solvers.py's tolerances (rtol 1e-4,
atol 1e-4 of the scale).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_sensorlessao_tpu.models import solvers as jsolvers
from mpc_sensorlessao_tpu.ops import newton_kkt as jnk
from mpc_sensorlessao_tpu_torch.benchmarks import cholesky_paths as cp
from mpc_sensorlessao_tpu_torch.benchmarks import latency_b1 as lb
from mpc_sensorlessao_tpu_torch.benchmarks import long_horizon as lh
from mpc_sensorlessao_tpu_torch.benchmarks import solver_throughput as st
from mpc_sensorlessao_tpu_torch.ops import newton_kkt

torch.backends.cuda.matmul.allow_tf32 = False
# one intra-op thread a worker: the suite runs one file per worker
torch.set_num_threads(1)

NX, B = 27, 4


def _close(got, want, rtol=1e-4, atol=1e-4):
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().cpu().numpy(), want, rtol=rtol,
                               atol=atol * np.abs(want).max())


def _jax_problem(prob):
    """The JAX FastMPCProblem of the port's float32 problem."""
    f = {k: jnp.asarray(getattr(prob, k).numpy())
         for k in ("A1", "A2", "B")}
    return jsolvers.make_fastmpc_problem(
        f["A1"], f["A2"], f["B"], q_weight=1.5e4, p_weight=1.5e4,
        r_weight=1.0, u_max=28.0, barrier_k=1e-2)


def _jax_args(x0, x0p, w):
    return tuple(jnp.asarray(a.numpy()) for a in (x0, x0p, w))


def test_solver_throughput_paths_match_jax():
    """Both timed paths on the script's problem (numpy seed 0) at B=4:
    fixed_op = solve_fixed on precompute_fixed_newton, structured = solve
    with one Newton step."""
    T = 2
    rng = np.random.default_rng(0)
    prob = st.problem(rng, NX, "cpu")
    args = st.states(rng, B, NX, T, "cpu")
    got = {k: f() for k, f in st.paths(prob, T, *args).items()}
    jp = _jax_problem(prob)
    op = jnk.precompute_fixed_newton(jp, T)
    want = {
        "fixed_op": jax.jit(jax.vmap(lambda a, b, c: jnk.solve_fixed(
            jp, op, a, b, c, horizon=T).U))(*_jax_args(*args)),
        "structured": jax.jit(jax.vmap(lambda a, b, c: jnk.solve(
            jp, a, b, c, horizon=T, n_newton=1).U))(*_jax_args(*args))}
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].shape == (B, T, 144)
        _close(got[k], want[k])


@pytest.mark.parametrize("T", [8, 32])
def test_long_horizon_backends_match_jax(T, monkeypatch):
    """Each Schur backend (cyclic reduction from horizon 1 on; dense
    Cholesky) against the JAX solve with the same CR_MIN_HORIZON, and the
    threshold restored after the block."""
    rng = np.random.default_rng(0)
    prob = st.problem(rng, NX, "cpu")
    args = st.states(rng, B, NX, T, "cpu")
    jp = _jax_problem(prob)
    saved = newton_kkt.CR_MIN_HORIZON
    for name, thr in lh.BACKENDS:
        with lh.cr_from(thr):
            assert newton_kkt.CR_MIN_HORIZON == thr
            got = lh.solve(prob, T, *args)
        assert newton_kkt.CR_MIN_HORIZON == saved
        monkeypatch.setattr(jnk, "CR_MIN_HORIZON", thr)
        want = jax.jit(jax.vmap(lambda a, b, c: jnk.solve.__wrapped__(
            jp, a, b, c, horizon=T, n_newton=1).U))(*_jax_args(*args))
        _close(got, want)
    with pytest.raises(RuntimeError):
        with lh.cr_from(1):
            raise RuntimeError
    assert newton_kkt.CR_MIN_HORIZON == saved


def test_cholesky_paths_match_jax():
    """raw-chol against the JAX cho_solve, inv-matmul against the dense
    solve, newton x1 / x2 against the JAX solve, on the script's draws
    (numpy seed 0) at B=4, T=2."""
    T = 2
    got = {k.split("(")[0].strip(): f() for k, f in cp.paths(
        np.random.default_rng(0), B, NX, T, "cpu").items()}
    rng = np.random.default_rng(0)
    S, b = cp.systems(rng, B, T * NX)
    S32, b32 = S.astype(np.float32), b.astype(np.float32)
    want_chol = jax.vmap(lambda s, r: jax.scipy.linalg.cho_solve(
        jax.scipy.linalg.cho_factor(s, lower=True), r))(S32, b32)
    _close(got["raw-chol"], want_chol)
    _close(got["inv-matmul"],
           b32 @ np.linalg.inv(S[0]).astype(np.float32).T)
    A1 = 0.9 * np.eye(NX) + 0.05 * rng.normal(size=(NX, NX))
    Bm = rng.normal(size=(NX, 144)) * 0.3
    jp = jsolvers.make_fastmpc_problem(
        jnp.asarray(A1, jnp.float32), jnp.asarray(-0.3 * np.eye(NX),
                                                  jnp.float32),
        jnp.asarray(Bm, jnp.float32), q_weight=1.5e4, p_weight=1.5e4,
        r_weight=1.0, u_max=28.0, barrier_k=1e-2)
    xs = [jnp.asarray(rng.normal(size=s) * k, jnp.float32)
          for s, k in (((B, NX), 1.0), ((B, NX), 1.0), ((B, T * NX), 0.1))]
    for nn in (1, 2):
        want = jax.vmap(lambda a, b_, c: jnk.solve(
            jp, a, b_, c, horizon=T, n_newton=nn).U)(*xs)
        _close(got[f"newton x{nn}"], want)


@pytest.mark.parametrize("module,argv,knob,names", [
    (st, ["8", "2", "5"], "ST_DEVICE", {"fixed_op", "structured"}),
    (lh, ["4", "5", "4,16"], "LH_DEVICE",
     {"T=4 cyclic-red", "T=4 dense-chol", "T=16 cyclic-red",
      "T=16 dense-chol"}),
    (cp, ["8", "5", "2"], "CP_DEVICE",
     {"raw-chol", "inv-matmul", "newton x1", "newton x2"})])
def test_solver_timer_mains_report_rates(module, argv, knob, names):
    """Each timer's main on "cpu": one positive rate per path."""
    rep = module.main(argv, {knob: "cpu"})
    assert set(rep) == names
    for row in rep.values():
        assert len(row) == 2 and all(v > 0 for v in row.values())


def test_latency_main_schema(tmp_path):
    """latency_b1 on the CPU at R=32: the JAX row's keys, the host-clock
    figure (the CUDA-event one and B1's launches exist on the card only),
    and the report written to the path given."""
    out = tmp_path / "lat.json"
    rep = lb.main([str(out)], {"LAT_DEVICE": "cpu", "LAT_RES": "32",
                               "LAT_STEPS": "3", "LAT_REPEATS": "3"})
    row = rep["rows"]["R=32"]
    assert set(row) == {"ms_per_step_b1", "iqr_ms", "budget_ms",
                        "x_under_budget", "meets_200hz",
                        "host_ms_per_step_b1", "host_iqr_ms"}
    assert row["ms_per_step_b1"] is None and row["iqr_ms"] is None
    assert row["host_ms_per_step_b1"] > 0
    lo, hi = row["host_iqr_ms"]
    assert lo <= hi
    assert row["meets_200hz"] == (row["host_ms_per_step_b1"] < 5.0)
    assert set(rep) == {"what", "steps", "repeats", "gauss_newton_iters",
                        "device", "rows"}
    assert out.exists() and list(tmp_path.iterdir()) == [out]


def test_latency_step_is_one_scenario():
    """The timed step: one scenario's loop from the test split, (T, ...)
    outputs, the same on injected noise whichever run it is."""
    cfg = lb.latency_cfg(32, 0)
    from mpc_sensorlessao_tpu_torch.models import pipeline
    system = pipeline.build(cfg, "cpu")
    noise = torch.as_tensor(np.random.default_rng(1).standard_normal(
        (3, system.est.n_pixels)).astype(np.float32)) * system.est.noise_std
    a = lb.step_run(system, cfg, 3, noise_seq=noise)
    b = lb.step_run(system, cfg, 3, noise_seq=noise)
    assert a.rms_res.shape == (3,)
    torch.testing.assert_close(a.u, b.u, rtol=0, atol=0)
