"""The benchmark of the PyTorch port ``mpc_sensorlessao_tpu_torch``:
``run.py`` runs one cell of ``BENCHMARK.json`` (see ``harness``)."""
