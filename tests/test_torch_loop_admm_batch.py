"""The ADMM case of test_run_batch_paths_take_every_solver
(tests/test_torch_loop.py holds the other solvers): ADMM through
run_batch's shared and batched windows and through with_horizon(N=16),
on the port's own build.  It runs in a file of its own because it takes
minutes on the CPU and the suite's workers run one file each
(tests/torch_loop_support.py holds the fixtures)."""

import pytest

from torch_loop_support import (_check_run_batch_paths,  # noqa: F401
                                port_system)


@pytest.mark.parametrize("solver,newton_steps", [("admm", 1)])
def test_run_batch_paths_take_every_solver(port_system, monkeypatch, solver,
                                           newton_steps):
    """As tests/test_torch_loop.py's test of the same name, for ADMM."""
    _check_run_batch_paths(port_system, monkeypatch, solver, newton_steps)
