"""Angular units and physical constants (port of
``mpc_sensorlessao_tpu/utils/units.py``).

Equivalent of the reference's unit helpers: the `constants` static class
(OOMAO-master/constants.m:1-23), `cougarConstants`
(cougarConstants.m:1-11), the `skyAngle` value class
(skyAngle.m:1-84) and the `arcsec.m` / `arcmin.m` one-liners.  Plain
floats + pure functions instead of a MATLAB value class: angles are
always stored in radians; `SkyAngle` is a tiny frozen wrapper kept only
for API parity with code that wants named-unit round-tripping.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

# constants.m:4-13 (SI)
RADIAN2ARCSEC = 180.0 * 3600.0 / math.pi
RADIAN2MAS = 1e3 * RADIAN2ARCSEC
RADIAN2ARCMIN = 180.0 * 60.0 / math.pi
ARCSEC2RADIAN = 1.0 / RADIAN2ARCSEC
ARCMIN2RADIAN = 1.0 / RADIAN2ARCMIN
PLANCK = 6.62606896e-34          # [J s]
C_LIGHT = 299792458.0            # [m/s]
M_EARTH = 5.9721986e24           # [kg]
R_EARTH = 6378.14e3              # [m]
G_GRAV = 6.67e-11                # [N m^2 / kg^2]

_TO_RADIAN = {
    "radian": 1.0,
    "arcmin": ARCMIN2RADIAN,
    "arcsec": ARCSEC2RADIAN,
    "mas": 1.0 / RADIAN2MAS,
    "degree": math.pi / 180.0,
}


def arcsec(val):
    """[arcsec] -> [rad] (arcsec.m, cougarConstants.m arcsec2radian)."""
    return val * ARCSEC2RADIAN


def arcmin(val):
    """[arcmin] -> [rad] (arcmin.m, constants.m:18-20)."""
    return val * ARCMIN2RADIAN


def mas(val):
    """[milliarcsec] -> [rad]."""
    return val / RADIAN2MAS


def to_unit(angle_rad: float, unit: str) -> float:
    """[rad] -> named unit (skyAngle.m:66-80 convert)."""
    return angle_rad / _TO_RADIAN[unit.lower()]


def from_unit(value: float, unit: str = "radian") -> float:
    """Named unit -> [rad] (skyAngle.m:14-35 constructor)."""
    return value * _TO_RADIAN[unit.lower()]


@dataclass(frozen=True)
class SkyAngle:
    """A sky angle stored in radians with a preferred display unit
    (skyAngle.m:1-84).  Arithmetic degenerates to floats via `.radian`;
    `plus` parity comes from constructing from summed radians."""
    radian: float
    unit: str = "radian"

    @classmethod
    def of(cls, value: float, unit: str = "radian") -> "SkyAngle":
        return cls(from_unit(value, unit), unit.lower())

    @property
    def arcsec(self) -> float:
        return to_unit(self.radian, "arcsec")

    @property
    def arcmin(self) -> float:
        return to_unit(self.radian, "arcmin")

    @property
    def mas(self) -> float:
        return to_unit(self.radian, "mas")

    @property
    def degree(self) -> float:
        return to_unit(self.radian, "degree")

    def convert(self, unit: str) -> float:
        return to_unit(self.radian, unit)

    def __add__(self, other: "SkyAngle") -> "SkyAngle":
        return SkyAngle(self.radian + other.radian, self.unit)

    def __str__(self) -> str:  # skyAngle.m:37-40 display
        return f"sky angle: {self.convert(self.unit):g} {self.unit}"


def heaviside(x):
    """Heaviside step with H(0)=1/2 (heaviside.m:1-10): a tensor stays a
    tensor on its device; anything else goes through numpy."""
    if isinstance(x, torch.Tensor):
        return 0.5 * (torch.sign(x) + 1.0)
    return 0.5 * (np.sign(x) + 1.0)


def marechal_strehl(rms_wfe_m: float, wavelength: float) -> float:
    """Extended Marechal Strehl approximation from an rms wavefront
    error in METERS (utilities.m:837-841: (1 - sigma^2/2)^2 with
    sigma = 2 pi rms / lambda)."""
    s = rms_wfe_m * 2.0 * math.pi / wavelength
    return (1.0 - s * s / 2.0) ** 2
