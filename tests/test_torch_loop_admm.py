"""The noise-free ADMM case of
test_simulate_matches_jax_with_carried_operators (tests/test_torch_loop.py
holds the other solvers): the port's loop on the JAX operators vs the
JAX loop, same injected noise, 400 ADMM iterations a step with the ramp
bounds shifted by u[k-1].  It runs in a file of its own because it takes
minutes on the CPU and the suite's workers run one file each
(tests/torch_loop_support.py holds the fixtures)."""

import pytest

from torch_loop_support import (_check_carried_loop, carried,  # noqa: F401
                                jax_system)


@pytest.mark.parametrize("solver,newton_steps", [
    pytest.param("admm", 1, id="admm")])
@pytest.mark.parametrize("noisy", [False])
def test_simulate_matches_jax_with_carried_operators(jax_system, carried,
                                                     solver, newton_steps,
                                                     noisy):
    """As tests/test_torch_loop.py's test of the same name, for ADMM."""
    _check_carried_loop(jax_system, carried, solver, noisy, "sym3",
                        newton_steps=newton_steps)
