"""mpc_sensorlessao_tpu_torch: the PyTorch/CUDA port of mpc_sensorlessao_tpu.

The same sensorless adaptive-optics MPC system as the JAX package beside
it -- frozen-flow Von Karman turbulence, Zernike modal decomposition, VAR
aberration prediction, phase-diversity PSF estimation and a fixed-barrier
Newton ("fastMPC") controller, batched over Monte-Carlo scenarios -- in
PyTorch, with the diversity-PSF measurement kernels as hand-written CUDA
kernels for Hopper (csrc/).

Layout (module and function names follow the JAX package):
  ops/        zernike, phase statistics, phase screens, partial DFT, PSF
              formation, the PSF kernel wrappers, fixed Newton-KKT solves
  models/     VAR system ID, DM influence, estimator, MPC matrices,
              solvers, closed-loop engine, pipeline
  parallel/   Monte-Carlo scenario batches
  utils/      config, special functions, metrics
  csrc/       CUDA sources, built with nvcc at first use
  benchmarks/ kernel_variants: the A/B of the measurement kernels
  interop.py  carries the JAX package's operators across as numpy arrays

Setup runs on the host in numpy float64 where precision matters; the
control step runs on the ``device`` given to the builders, the card
("cuda") unless the caller passes "cpu".  The package never imports jax.
"""

from .utils import config
from .utils.config import (
    AtmosphereConfig,
    DMConfig,
    EstimatorConfig,
    MPCConfig,
    SimConfig,
    SystemConfig,
    TelescopeConfig,
    ZernikeConfig,
    mag_conv,
    reference_config,
    strong_turbulence,
)

__version__ = "0.1.0"
