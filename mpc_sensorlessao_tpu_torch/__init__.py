"""mpc_sensorlessao_tpu_torch: the PyTorch/CUDA port of mpc_sensorlessao_tpu.

The same sensorless adaptive-optics MPC system as the JAX package beside
it -- frozen-flow Von Karman turbulence, Zernike modal decomposition, VAR
aberration prediction, phase-diversity PSF estimation and a fixed-barrier
Newton ("fastMPC") controller, batched over Monte-Carlo scenarios -- in
PyTorch, with the diversity-PSF measurement kernels as hand-written CUDA
kernels for Hopper (csrc/).

Layout (module and function names follow the JAX package):
  ops/        zernike, zernike statistics (grid propagation and the
              spectral analytics), Karhunen-Loeve modes, phase
              statistics, phase screens, the conditional flow, partial
              DFT, PSF formation, the PSF kernel wrappers, Newton-KKT
              solves, block cyclic reduction; the Toeplitz-block-Toeplitz
              operator, the relay projection (off-axis, LGS cone),
              Fourier-AO error budget, telescope optics, paraxial ray
              tracing, segmented pupils
  models/     VAR system ID, DM influence, estimator, MPC matrices,
              solvers, closed-loop engine, pipeline; the classical
              baseline: Shack-Hartmann and pyramid WFS, integrator,
              detector/imager; slopes-MMSE reconstruction (NGS, zonal
              tomography, LGS), laser guide star, modal tomography,
              modal MCAO
  parallel/   Monte-Carlo scenario batches, the scenario-sharded runner,
              the tensor-parallel estimate, the horizon solve
  utils/      config, special functions, metrics, units, photometry,
              grid tools, log book, display, profiling, checkpoints
  csrc/       CUDA sources, built with nvcc at first use
  benchmarks/ the kernel A/B, device peaks, roofline, the population,
              the classical-vs-MPC comparison
  examples/   the JAX package's demos: closed loop, horizon sweep,
              turbulence statistics, wavefront sensing, MCAO
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
