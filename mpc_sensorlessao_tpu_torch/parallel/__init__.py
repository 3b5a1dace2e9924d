"""Scenario-parallel execution of the PyTorch port: Monte-Carlo scenario
batches (montecarlo), the scenario-sharded runner and its statistics
over a torch.distributed world (montecarlo, mesh, multihost), the
tensor-parallel estimator (estimator_tp), the horizon-parallel
block-tridiagonal solve (horizon) and their multi-rank dry run
(dryrun)."""
