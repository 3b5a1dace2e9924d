"""Domain models of the PyTorch port: estimator, DM, VAR, MPC, loop."""
