"""The port's general MPC solvers vs the JAX package's (ROADMAP A.8):
block cyclic reduction (ops/block_tridiag.py), the multi-step Newton-KKT
solve with ramp rows (ops/newton_kkt.py), the dense stacked oracle,
geninv and the condensed ADMM (models/solvers.py).

The same numpy-seeded float32 inputs go through the JAX function, under
``jax.vmap`` over scenarios, and through the port's batched function on
the CPU.  Unless stated, results agree to rtol 1e-4 / atol 1e-4 of their
scale: the structured-vs-dense tolerance of the JAX package's own
solver tests (tests/test_fixed_newton.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_sensorlessao_tpu.models import mpc as jmpc
from mpc_sensorlessao_tpu.models import solvers as jsolvers
from mpc_sensorlessao_tpu.ops import block_tridiag as jbt
from mpc_sensorlessao_tpu.ops import newton_kkt as jnk
from mpc_sensorlessao_tpu_torch.models import mpc, solvers
from mpc_sensorlessao_tpu_torch.ops import block_tridiag as bt
from mpc_sensorlessao_tpu_torch.ops import newton_kkt

torch.backends.cuda.matmul.allow_tf32 = False
# the suite runs one test file per worker process, several at once: one
# intra-op thread each keeps torch's thread pools from oversubscribing the
# cores (which slows small eager ops many times over)
torch.set_num_threads(1)

SCENARIOS = 4


def t32(a):
    return torch.as_tensor(np.asarray(a, dtype=np.float32))


def npy(t):
    return t.detach().cpu().numpy()


def _close(got, want, rtol=1e-4, atol=1e-4, err_msg=""):
    """Agreement to rtol, and to atol of the reference's scale."""
    want = np.asarray(want)
    np.testing.assert_allclose(npy(got) if isinstance(got, torch.Tensor)
                               else got, want, rtol=rtol,
                               atol=atol * np.abs(want).max(),
                               err_msg=err_msg)


# --------------------------------------------------------- cyclic reduction

def _spd_tridiag(rng, J, n):
    """Random SPD block-tridiagonal system (diag, sub), cond ~1e2."""
    L = [np.linalg.qr(rng.normal(size=(n, n)))[0] + 2 * np.eye(n)
         for _ in range(J)]
    S = [0.3 * rng.normal(size=(n, n)) for _ in range(J)]
    diag, sub = [], [np.zeros((n, n))]
    for j in range(J):
        d = L[j] @ L[j].T
        if j > 0:
            d = d + S[j] @ S[j].T
            sub.append(S[j] @ L[j - 1].T)
        diag.append(d)
    return np.array(diag), np.array(sub)


def _spd_banded(rng, T, n):
    """Random SPD bandwidth-2 block-banded system (S, diag, sub1, sub2)."""
    F = np.zeros((T * n, T * n))
    for t in range(T):
        blk = slice(t * n, (t + 1) * n)
        F[blk, blk] = np.linalg.qr(rng.normal(size=(n, n)))[0] + 2.5 * np.eye(n)
        for k, s in ((1, 0.3), (2, 0.2)):
            if t >= k:
                F[blk, (t - k) * n:(t - k + 1) * n] = s * rng.normal(
                    size=(n, n))
    S = F @ F.T
    z = np.zeros((n, n))

    def band(k):
        return np.array([S[t * n:(t + 1) * n, (t - k) * n:(t - k + 1) * n]
                         if t >= k else z for t in range(T)])
    return S, band(0), band(1), band(2)


@pytest.mark.parametrize("J,n", [(1, 3), (2, 3), (5, 4), (8, 3), (17, 3)])
def test_cr_solve_matches_jax(J, n):
    """cr_solve on a batch of random SPD block-tridiagonal systems, J even
    and odd (identity padding), vs jax.vmap of the JAX cr_solve and
    numpy's dense solve (float64)."""
    rng = np.random.default_rng(J)
    systems = [_spd_tridiag(rng, J, n) for _ in range(SCENARIOS)]
    diag = np.array([d for d, _ in systems], np.float32)
    sub = np.array([s for _, s in systems], np.float32)
    rhs = rng.normal(size=(SCENARIOS, J, n)).astype(np.float32)
    got = bt.cr_solve(t32(diag), t32(sub), t32(rhs))
    want = jax.jit(jax.vmap(jbt.cr_solve))(diag, sub, rhs)
    assert got.shape == rhs.shape
    _close(got, want)
    # a (J, n, k) right-hand side, float64 against numpy
    rhs2 = rng.normal(size=(SCENARIOS, J, n, 2))
    x = npy(bt.cr_solve(torch.as_tensor(diag, dtype=torch.float64),
                        torch.as_tensor(sub, dtype=torch.float64),
                        torch.as_tensor(rhs2)))
    for i in range(SCENARIOS):
        dense = np.zeros((J * n, J * n))
        for j in range(J):
            dense[j * n:(j + 1) * n, j * n:(j + 1) * n] = diag[i, j]
            if j:
                dense[j * n:(j + 1) * n, (j - 1) * n:j * n] = sub[i, j]
                dense[(j - 1) * n:j * n, j * n:(j + 1) * n] = sub[i, j].T
        want = np.linalg.solve(dense, rhs2[i].reshape(J * n, 2))
        np.testing.assert_allclose(x[i].reshape(J * n, 2), want, rtol=1e-9,
                                   atol=1e-9 * np.abs(want).max())


@pytest.mark.parametrize("T,n", [(2, 3), (3, 3), (7, 4), (20, 3), (31, 4)])
def test_banded_solve_matches_jax(T, n):
    """banded_solve (pair packing + cyclic reduction) on random SPD
    bandwidth-2 systems, T even and odd, vs jax.vmap of the JAX
    banded_solve; pack_pairs' blocks vs the JAX ones exactly."""
    rng = np.random.default_rng(100 + T)
    systems = [_spd_banded(rng, T, n) for _ in range(SCENARIOS)]
    blocks = [np.array([s[k] for s in systems], np.float32)
              for k in (1, 2, 3)]
    rhs = rng.normal(size=(SCENARIOS, T, n)).astype(np.float32)
    got = bt.banded_solve(*map(t32, blocks), t32(rhs))
    want = jax.jit(jax.vmap(jbt.banded_solve))(*blocks, rhs)
    assert got.shape == rhs.shape
    _close(got, want)
    D, L, Tp = bt.pack_pairs(*map(t32, blocks))
    jD, jL, jTp = jax.vmap(jbt.pack_pairs, out_axes=(0, 0, None))(*blocks)
    assert Tp == jTp
    np.testing.assert_array_equal(npy(D), np.asarray(jD))
    np.testing.assert_array_equal(npy(L), np.asarray(jL))


def test_failed_factor_gives_nan_to_its_own_system_only():
    """A scenario whose block is not positive definite gets NaN, the
    others their solution -- never an exception (the JAX cho_factor's
    behaviour): in cr_solve, in banded_solve, and in the Newton
    direction's dense Schur factor."""
    rng = np.random.default_rng(3)
    systems = [_spd_tridiag(rng, 5, 3) for _ in range(3)]
    diag = torch.as_tensor(np.array([d for d, _ in systems]))
    sub = torch.as_tensor(np.array([s for _, s in systems]))
    rhs = torch.as_tensor(rng.normal(size=(3, 5, 3)))
    bad = diag.clone()
    bad[1, 3] = -bad[1, 3]
    x = bt.cr_solve(bad, sub, rhs)
    assert torch.isnan(x[1]).all()
    torch.testing.assert_close(x[[0, 2]], bt.cr_solve(diag, sub, rhs)[[0, 2]])
    S, d, s1, s2 = _spd_banded(rng, 20, 3)
    blocks = [torch.as_tensor(np.stack([a, a])) for a in (d, s1, s2)]
    blocks[0][0, 7] = -blocks[0][0, 7]
    x = bt.banded_solve(*blocks, torch.as_tensor(rng.normal(size=(2, 20, 3))))
    assert torch.isnan(x[0]).all() and torch.isfinite(x[1]).all()
    # Newton direction: a negative control weight leaves Phi_u > 0 only
    # where the barrier is steep (scenario 1, next to the box), so
    # scenario 0's Schur complement is indefinite
    prob, x0, xp, w, T = _problem(rng, n=3, m=2, T=3)
    prob = dataclasses.replace(prob, r_diag=torch.full((2,), -50.0))
    b = newton_kkt.equality_rhs(prob, t32(x0[:2]), t32(xp[:2]), t32(w[:2]),
                                T)
    U = torch.zeros((2, T, 2))
    U[1] = 1.99
    st = newton_kkt.SolverState(U, torch.zeros((2, T, 3)),
                                torch.zeros((2, T, 3)))
    dU, dX, dnu = newton_kkt.newton_direction(prob, b, st)
    assert torch.isnan(dnu[0]).all() and torch.isfinite(dnu[1]).all()


# ------------------------------------------------------------ Newton-KKT

def _problem(rng, n=3, m=2, T=3, du=0.4):
    """A small VAR(2) problem (the JAX solver tests' scale: box 2, ramp
    0.4) as port and JAX FastMPCProblems' shared data, plus per-scenario
    x0, x0_pre, w (numpy float32)."""
    A1 = 0.5 * np.eye(n) + 0.1 * rng.normal(size=(n, n))
    A2 = 0.15 * np.eye(n) + 0.05 * rng.normal(size=(n, n))
    B = rng.normal(size=(n, m))
    prob = solvers.make_fastmpc_problem(
        t32(A1), t32(A2), t32(B), q_weight=10.0, p_weight=10.0,
        r_weight=1.0, u_max=2.0, barrier_k=1e-2, du_max=du)
    f32 = np.float32
    x0 = (rng.normal(size=(SCENARIOS, n)) * 0.5).astype(f32)
    xp = (rng.normal(size=(SCENARIOS, n)) * 0.5).astype(f32)
    w = (rng.normal(size=(SCENARIOS, T * n)) * 0.3).astype(f32)
    return prob, x0, xp, w, T


def _jax_prob(prob, u_prev=None):
    """The JAX FastMPCProblem of a port problem (u_prev: one scenario's)."""
    fields = {f.name: jnp.asarray(npy(getattr(prob, f.name)))
              for f in dataclasses.fields(prob)}
    if u_prev is not None:
        fields["u_prev"] = jnp.asarray(u_prev)
    return jnk.FastMPCProblem(**fields)


def _ramp_case(rng, prob, ramp):
    """Per-scenario u_prev (B, m) for the ramp rows (|u_prev| up to 1.5,
    beyond du_max, so the init clip and the ramp slacks matter)."""
    if not ramp:
        return prob, None
    u_prev = rng.uniform(-1.5, 1.5, size=(SCENARIOS, prob.B.shape[1]))
    u_prev = u_prev.astype(np.float32)
    return dataclasses.replace(prob, u_prev=t32(u_prev)), u_prev


def _jax_solve(prob, u_prev, x0, xp, w, T, n_newton, ramp):
    def one(a, b_, c_, up):
        p = _jax_prob(prob) if up is None else _jax_prob(prob)._replace(
            u_prev=up)
        return jnk.solve(p, a, b_, c_, horizon=T, n_newton=n_newton,
                         ramp=ramp)
    if u_prev is None:
        return jax.vmap(lambda a, b_, c_: one(a, b_, c_, None))(x0, xp, w)
    return jax.vmap(one)(x0, xp, w, u_prev)


@pytest.mark.parametrize("ramp", [False, True])
@pytest.mark.parametrize("T", [3, 20])
def test_newton_direction_matches_jax(T, ramp):
    """One Newton direction from the (ramp-feasible) init, per scenario:
    dense Schur at T=3, cyclic reduction at T=20 (ramp rows: dense at
    both), vs jax.vmap of the JAX newton_direction."""
    rng = np.random.default_rng(10 * T + ramp)
    prob, x0, xp, w, T = _problem(rng, T=T)
    prob, u_prev = _ramp_case(rng, prob, ramp)
    b = newton_kkt.equality_rhs(prob, t32(x0), t32(xp), t32(w), T)
    st = newton_kkt.init_state(prob, T, ramp=ramp)
    got = newton_kkt.newton_direction(prob, b, st, ramp=ramp)

    def one(a, b_, c_, up):
        p = _jax_prob(prob, up)
        jb = jnk.equality_rhs(p, a, b_, c_, T)
        return jnk.newton_direction(p, jb, jnk.init_state(p, T, 0.0, ramp),
                                    ramp=ramp)
    up = u_prev if ramp else np.zeros((SCENARIOS, prob.B.shape[1]),
                                      np.float32)
    want = jax.jit(jax.vmap(one))(x0, xp, w, up)
    for name, g, wv in zip(("dU", "dX", "dnu"), got, want):
        assert g.shape == wv.shape, name
        _close(g, wv, err_msg=name)


@pytest.mark.parametrize("n_newton", [1, 2, 8])
@pytest.mark.parametrize("ramp", [False, True])
@pytest.mark.parametrize("T", [3, 20])
def test_solve_matches_jax(T, ramp, n_newton):
    """newton_kkt.solve with n_newton Newton steps and the line search,
    batched, vs jax.vmap of the JAX solve, with and without ramp rows;
    with ramp rows every scenario's U keeps its ramp bound."""
    rng = np.random.default_rng(1000 + 10 * T + 2 * ramp + n_newton)
    prob, x0, xp, w, T = _problem(rng, T=T)
    prob, u_prev = _ramp_case(rng, prob, ramp)
    got = newton_kkt.solve(prob, t32(x0), t32(xp), t32(w), horizon=T,
                           n_newton=n_newton, ramp=ramp)
    want = _jax_solve(prob, u_prev, x0, xp, w, T, n_newton, ramp)
    for name in ("U", "X", "nu"):
        _close(getattr(got, name), getattr(want, name), err_msg=name)
    U = npy(got.U)
    assert np.abs(U).max() < 2.0
    if ramp:
        steps = np.diff(np.concatenate([u_prev[:, None], U], axis=1), axis=1)
        assert np.abs(steps).max() < 0.4


@pytest.mark.parametrize("n_newton", [1, 2, 8])
def test_cyclic_reduction_matches_dense_schur(monkeypatch, n_newton):
    """At T=20 >= CR_MIN_HORIZON the port's solve runs cyclic reduction;
    with CR_MIN_HORIZON raised past T it runs the dense Schur factor
    instead, and the two agree (tests/test_block_tridiag.py's check, at
    this module's tolerance)."""
    rng = np.random.default_rng(7 + n_newton)
    prob, x0, xp, w, T = _problem(rng, T=20)
    assert T >= newton_kkt.CR_MIN_HORIZON
    args = (prob, t32(x0), t32(xp), t32(w))
    cr = newton_kkt.solve(*args, horizon=T, n_newton=n_newton)
    monkeypatch.setattr(newton_kkt, "CR_MIN_HORIZON", 10_000)
    dense = newton_kkt.solve(*args, horizon=T, n_newton=n_newton)
    for name in ("U", "X", "nu"):
        _close(getattr(cr, name), npy(getattr(dense, name)), err_msg=name)


def test_solve_single_step_matches_solve_fixed():
    """solve(n_newton=1) from the midpoint equals the precomputed-operator
    solve_fixed (tests/test_fixed_newton.py: rtol 1e-4, atol 1e-5 on U,
    1e-4 on X)."""
    rng = np.random.default_rng(0)
    prob, x0, xp, w, T = _problem(rng, T=3)
    op = newton_kkt.precompute_fixed_newton(prob, T)
    args = (prob, t32(x0), t32(xp), t32(w))
    s1 = newton_kkt.solve(*args, horizon=T, n_newton=1)
    s2 = newton_kkt.solve_fixed(prob, op, *args[1:], horizon=T)
    torch.testing.assert_close(s2.U, s1.U, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(s2.X, s1.X, rtol=1e-4, atol=1e-4)


def test_fastmpc_and_barrier_continuation_match_jax():
    """solvers.fastmpc (stacked U) and newton_kkt.solve_barrier_continuation
    (k = 1, 0.1, ..., 20 line-searched Newton steps each) vs the JAX
    functions under vmap."""
    rng = np.random.default_rng(5)
    prob, x0, xp, w, T = _problem(rng, T=3)
    jp = _jax_prob(prob)
    got = solvers.fastmpc(prob, t32(x0), t32(xp), t32(w), horizon=T,
                          n_newton=2)
    want = jax.vmap(lambda a, b_, c_: jsolvers.fastmpc(
        jp, a, b_, c_, horizon=T, n_newton=2))(x0, xp, w)
    assert got.shape == (SCENARIOS, T * prob.B.shape[1])
    _close(got, want)
    got = newton_kkt.solve_barrier_continuation(prob, t32(x0), t32(xp),
                                                t32(w), horizon=T)
    want = jax.jit(jax.vmap(lambda a, b_, c_: jnk.solve_barrier_continuation(
        jp, a, b_, c_, horizon=T)))(x0, xp, w)
    for name in ("U", "X", "nu"):
        _close(getattr(got, name), getattr(want, name), err_msg=name)


# ------------------------------------------------------------ dense oracle

@pytest.mark.parametrize("ramp", [False, True])
def test_dense_oracle_matches_jax_and_structured(ramp):
    """assemble_dense (batched over x0, x0_pre, w, u_prev) gives the JAX
    matrices exactly and its rhs to float32 rounding;
    dense_newton_solve (4 Newton steps) agrees with the JAX one under vmap
    and with the structured solve (the JAX tests' 2e-3)."""
    rng = np.random.default_rng(21 + ramp)
    prob, x0, xp, w, T = _problem(rng, T=3)
    prob, u_prev = _ramp_case(rng, prob, ramp)
    m = prob.B.shape[1]
    n = prob.B.shape[0]
    up = (u_prev if ramp else np.zeros((SCENARIOS, m), np.float32))
    mats = [torch.diag(prob.q_diag), torch.diag(prob.r_diag),
            torch.diag(prob.qf_diag), prob.A1, prob.A2, prob.B]
    bounds = [prob.u_min, prob.u_max, prob.du_min, prob.du_max]
    dp = solvers.assemble_dense(*mats, t32(w), t32(x0), t32(xp), t32(up),
                                *bounds, horizon=T, ramp=ramp,
                                barrier_k=0.01)
    jmats = [jnp.asarray(npy(a)) for a in mats]
    jbounds = [jnp.asarray(npy(a)) for a in bounds]

    def jdense(w_, a, b_, u):
        return jsolvers.assemble_dense(*jmats, w_, a, b_, u, *jbounds,
                                       horizon=T, ramp=ramp, barrier_k=0.01)
    jdp = jax.jit(jax.vmap(jdense))(w, x0, xp, up)
    for name in ("H", "g", "P", "C"):
        np.testing.assert_array_equal(npy(getattr(dp, name)),
                                      np.asarray(getattr(jdp, name))[0])
    for name in ("h", "b", "z_init"):
        want = np.asarray(getattr(jdp, name))
        got = npy(getattr(dp, name))
        np.testing.assert_allclose(np.broadcast_to(got, want.shape), want,
                                   rtol=1e-6, atol=1e-6, err_msg=name)
    z = solvers.dense_newton_solve(dp, n_newton=4)
    jz = jax.jit(jax.vmap(
        lambda p: jsolvers.dense_newton_solve(p, n_newton=4)))(jdp)
    _close(z, jz)
    U, X = solvers.unpack_controls(z, n, m, T)
    assert U.shape == (SCENARIOS, T, m) and X.shape == (SCENARIOS, T, n)
    st = newton_kkt.solve(prob, t32(x0), t32(xp), t32(w), horizon=T,
                          n_newton=4, ramp=ramp)
    np.testing.assert_allclose(npy(st.U), npy(U), rtol=2e-3, atol=2e-3)


# ------------------------------------------------------------------ geninv

@pytest.mark.parametrize("shape,rank", [((6, 4), 4), ((4, 7), 4),
                                        ((8, 5), 3)])
def test_geninv_matches_jax_and_pinv(shape, rank):
    """geninv on a batch of matrices, tall and wide, vs the JAX geninv
    under vmap and numpy.linalg.pinv, in float32.  A rank-deficient batch
    runs in float64 against pinv only: its dropped columns have pivots at
    the float32 roundoff of A, ~1e-7 of its scale, far above the
    1e-9 tolerance, so neither package's float32 geninv drops them."""
    rng = np.random.default_rng(sum(shape) + rank)
    m, n = shape
    G = np.array([rng.normal(size=(m, rank)) @ rng.normal(size=(rank, n))
                  for _ in range(3)])
    want = np.linalg.pinv(G)
    if rank < min(shape):
        got = solvers.geninv(torch.as_tensor(G))
        _close(got, want, rtol=1e-6, atol=1e-6)
        return
    got = solvers.geninv(t32(G))
    assert got.shape == (3, n, m)
    _close(got, jax.jit(jax.vmap(jsolvers.geninv))(G.astype(np.float32)),
           rtol=1e-3, atol=1e-3)
    _close(got, want, rtol=1e-3, atol=1e-3)


# -------------------------------------------------------------------- ADMM

def _admm_problem(seed, n_scen=SCENARIOS):
    """A condensed QP with active box and ramp rows (the JAX ADMM-vs-scipy
    test's weights Q 10, R 1, box 0.8), N=3, with per-scenario linear
    terms r of growing scale and ramp bounds (B, N*nu) whose first block
    is shifted, as the loop shifts it by u[k-1]."""
    rng = np.random.default_rng(seed)
    nx, nu, N = 4, 3, 3
    A1 = 0.5 * np.eye(nx) + 0.05 * rng.normal(size=(nx, nx))
    A2 = 0.1 * np.eye(nx)
    B = rng.normal(size=(nx, nu))
    args = [np.asarray(a, np.float32) for a in (A1, A2, B)]
    weights = [np.asarray(a, np.float32)
               for a in (10 * np.eye(nx), 10 * np.eye(nx), np.eye(nu))]
    mats = mpc.design_matrices(*map(t32, args), N, *map(t32, weights))
    jmats = jmpc.design_matrices(*map(jnp.asarray, args), N,
                                 *map(jnp.asarray, weights))
    scale = np.array([1.0, 3.0, 10.0, 30.0])[:n_scen, None]
    r = (rng.normal(size=(n_scen, N * nu)) * scale).astype(np.float32)
    lo = np.full((N * nu,), -0.8, np.float32)
    shift = np.zeros((n_scen, N * nu), np.float32)
    shift[:, :nu] = rng.uniform(-0.5, 0.5, size=(n_scen, nu))
    return (mats, jmats, r, lo, -lo, (shift - 0.3).astype(np.float32),
            (shift + 0.3).astype(np.float32))


@pytest.mark.parametrize("adapt_rounds", [0, 2])
def test_admm_matches_jax_per_scenario(adapt_rounds):
    """admm_condensed on a batch of problems (per-scenario r and ramp
    bounds), 30 iterations, return_info=True, tol 1e-3, vs jax.vmap of the
    JAX function: U to rtol 1e-3 (atol 1e-3 of its scale), the same
    converged flags (none at adapt_rounds=0, three of four at 2), the
    telemetry to 1e-2 and, with adapt_rounds=2, the per-scenario rho
    (residual balancing per scenario, not over the batch)."""
    mats, jmats, r, lo, hi, dlo, dhi = _admm_problem(4)
    kw = dict(n_iter=30, tol=1e-3, adapt_rounds=adapt_rounds,
              return_info=True)
    U, info = solvers.admm_condensed(mats, t32(r), t32(lo), t32(hi),
                                     t32(dlo), t32(dhi), **kw)
    jU, jinfo = jax.jit(jax.vmap(
        lambda r_, a, b_: jsolvers.admm_condensed(jmats, r_, lo, hi, a, b_,
                                                  **kw)))(r, dlo, dhi)
    _close(U, jU, rtol=1e-3, atol=1e-3)
    np.testing.assert_array_equal(npy(info.converged),
                                  np.asarray(jinfo.converged))
    for name in ("primal_rms", "dual_rms", "rho"):
        _close(getattr(info, name), getattr(jinfo, name), rtol=1e-2,
               atol=1e-3, err_msg=name)
    if adapt_rounds:
        assert len(set(npy(info.rho).tolist())) > 1
    assert npy(info.converged).sum() == (3 if adapt_rounds else 0)
    assert np.abs(npy(U)).max() <= 0.8 + 1e-3


def test_admm_without_info_and_single_scenario():
    """admm_condensed with the loop's defaults (400 iterations, default
    rho) returns U alone, shaped as r; one unbatched problem gives the
    batch's row."""
    mats, _, r, lo, hi, dlo, dhi = _admm_problem(6, n_scen=2)
    U = solvers.admm_condensed(mats, t32(r), t32(lo), t32(hi), t32(dlo),
                               t32(dhi))
    assert U.shape == r.shape
    one = solvers.admm_condensed(mats, t32(r[1]), t32(lo), t32(hi),
                                 t32(dlo[1]), t32(dhi[1]))
    torch.testing.assert_close(one, U[1], rtol=1e-5, atol=1e-5)
