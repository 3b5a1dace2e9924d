"""Plain float64 reference of the sensorless-AO closed loop.

Written from the configuration files alone: it imports neither JAX, the
JAX package nor the PyTorch port, and takes nothing the port has made.
Every operator the port's set-up derives -- the Zernike basis, the pupil
and diversity maps, the linearised PSF model and its LS or MMSE gain
(with the analytic Von Karman prior), the DM influence matrix, the VAR
fit on the identification rollout, the condensed fastMPC problem and
the warm-start command -- is worked out again here, in float64, from the
same configuration and the same seeded random draws.

Modules: ``turbulence`` (phase screens and their frozen-flow windows),
``optics`` (basis, pupil, PSF crops, estimator gains, DM, the prior),
``control`` (VAR fit, fastMPC Newton step, warm start) and ``system``
(the whole build and one batched closed-loop step).
"""
