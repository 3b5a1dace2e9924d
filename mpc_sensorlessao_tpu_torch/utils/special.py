"""Special functions needed by the Von Karman turbulence statistics.

The reference relies on MATLAB's ``besselk(5/6, u)`` and ``gamma`` for the
phase covariance (reference: OOMAO-master/phaseStats.m:20-39).  JAX ships
neither the modified Bessel function of real fractional order nor a float64
default, so we implement K_nu for static fractional nu from scratch:

* small/moderate ``x``: series via  K_nu = pi/2 (I_{-nu} - I_nu)/sin(nu pi),
  with I_nu power series whose coefficients are host-precomputed from exact
  gamma values;
* large ``x``: exponentially-scaled asymptotic expansion.

Functions take the array module as ``xp`` (the port passes ``numpy``, for
float64 setup-time use).  A copy of ``mpc_sensorlessao_tpu/utils/special.py``.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np

_SERIES_TERMS = 32
_ASYMPTOTIC_TERMS = 10
_CROSSOVER = 8.0


@lru_cache(maxsize=None)
def _series_coeffs(nu: float, sign: int):
    """Coefficients c_k of I_{sign*nu}(x) = (x/2)^{sign*nu} sum c_k (x/2)^(2k)."""
    v = sign * nu
    return tuple(
        1.0 / (math.factorial(k) * math.gamma(k + v + 1.0))
        for k in range(_SERIES_TERMS)
    )


@lru_cache(maxsize=None)
def _asymptotic_coeffs(nu: float):
    """a_k of K_nu(x) ~ sqrt(pi/2x) e^-x sum a_k x^-k."""
    mu = 4.0 * nu * nu
    coeffs = [1.0]
    num = 1.0
    for k in range(1, _ASYMPTOTIC_TERMS):
        num *= mu - (2 * k - 1) ** 2
        coeffs.append(num / (math.factorial(k) * 8.0 ** k))
    return tuple(coeffs)


def kv_frac(nu: float, x, xp=np):
    """Modified Bessel function K_nu(x) for static fractional order nu > 0.

    ``x`` must be positive; values at x<=0 are undefined (callers handle the
    rho=0 limit separately, as the reference does at phaseStats.m:33-37).
    """
    if not (0.0 < nu < 1.0):
        raise ValueError("kv_frac supports fractional order 0 < nu < 1")
    x = xp.asarray(x)
    xs = xp.where(x > 0, x, xp.ones_like(x))  # keep grads/NaNs tame

    # --- series branch: K = pi/2 (I_-nu - I_nu)/sin(nu pi) ---
    half = xs / 2.0
    q = half * half
    c_pos = _series_coeffs(nu, +1)
    c_neg = _series_coeffs(nu, -1)
    s_pos = xp.zeros_like(xs)
    s_neg = xp.zeros_like(xs)
    for k in reversed(range(_SERIES_TERMS)):
        s_pos = s_pos * q + c_pos[k]
        s_neg = s_neg * q + c_neg[k]
    i_pos = half ** nu * s_pos
    i_neg = half ** (-nu) * s_neg
    k_series = (math.pi / 2.0) / math.sin(nu * math.pi) * (i_neg - i_pos)

    # --- asymptotic branch ---
    a = _asymptotic_coeffs(nu)
    inv = 1.0 / xs
    s_asym = xp.zeros_like(xs)
    for k in reversed(range(_ASYMPTOTIC_TERMS)):
        s_asym = s_asym * inv + a[k]
    k_asym = xp.sqrt(math.pi / 2.0 * inv) * xp.exp(-xs) * s_asym

    return xp.where(xs < _CROSSOVER, k_series, k_asym)


def gamma(x: float) -> float:
    """Host-side gamma for real scalar arguments (constant folding)."""
    return math.gamma(x)
