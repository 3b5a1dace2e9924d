"""Runnable demos, the port's counterparts of the repository's examples/
(``python -m mpc_sensorlessao_tpu_torch.examples.<name>``)."""
