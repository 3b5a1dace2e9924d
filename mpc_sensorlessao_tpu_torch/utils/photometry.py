"""Astronomical photometric bands (port of
``mpc_sensorlessao_tpu/utils/photometry.py``).

Equivalent of the reference's `photometry` enumeration class
(reference: OOMAO-master/photometry.m:44-66): per-band wavelength [m],
bandwidth [m], and zero point [photons/m^2/s]; V band anchors the
turbulence wavelength (photometry.m:50, README.md:63).
"""

from __future__ import annotations

import math
from dataclasses import dataclass


@dataclass(frozen=True)
class Band:
    name: str
    wavelength: float      # [m]
    bandwidth: float       # [m]
    zero_point: float      # [photon / m^2 / s]

    def n_photon(self, magnitude: float) -> float:
        """Photon flux for a star of given magnitude
        (photometry.m:18-21: zeroPoint * 10^(-0.4 mag))."""
        return self.zero_point * 10.0 ** (-0.4 * magnitude)

    def n_background(self, mag_per_arcsec2: float,
                     area_arcsec2: float) -> float:
        return self.n_photon(mag_per_arcsec2) * area_arcsec2


# Values from photometry.m:44-66 (wavelength, bandwidth, zeroPoint).
U = Band("U", 0.360e-6, 0.070e-6, 2.0e12)
B = Band("B", 0.440e-6, 0.100e-6, 5.4e12)
V0 = Band("V0", 0.500e-6, 0.090e-6, 3.3e12)
V = Band("V", 0.550e-6, 0.090e-6, 3.3e12)
R = Band("R", 0.640e-6, 0.150e-6, 4.0e12)
I = Band("I", 0.790e-6, 0.150e-6, 2.7e12)
J = Band("J", 1.215e-6, 0.260e-6, 1.9e12)
H = Band("H", 1.654e-6, 0.290e-6, 1.1e12)
K = Band("K", 2.179e-6, 0.410e-6, 7.0e11)
L = Band("L", 3.547e-6, 0.570e-6, 2.5e11)
M = Band("M", 4.769e-6, 0.450e-6, 2.5e10)

BANDS = {b.name: b for b in (U, B, V0, V, R, I, J, H, K, L, M)}

# GMT photometric system (gmtPhotometry.m:57-71): zero points are quoted
# as TOTAL photons/s through the 368 m^2 GMT collecting area; the
# constructor divides by 368 (gmtPhotometry.m:25) to express them in the
# per-m^2 convention of `Band` above.
GMT_AREA = 368.0  # [m^2]
GMT_BANDS = {
    name: Band("GMT_" + name, w, bw, zp / GMT_AREA)
    for name, w, bw, zp in (
        ("U", 0.360e-6, 0.070e-6, 2.0e12),
        ("B", 0.440e-6, 0.100e-6, 5.4e12),
        ("V", 0.550e-6, 0.090e-6, 3.3e12),
        ("R", 0.640e-6, 0.150e-6, 4.0e12),
        ("I", 0.790e-6, 0.150e-6, 2.7e12),
        ("J", 1.215e-6, 0.260e-6, 1.9e12),
        ("H", 1.654e-6, 0.290e-6, 1.1e12),
        ("Ks", 2.157e-6, 0.320e-6, 5.5e11),
        ("K", 2.179e-6, 0.410e-6, 7.0e11),
        ("L", 3.547e-6, 0.570e-6, 2.5e11),
        ("M", 4.769e-6, 0.450e-6, 8.4e10),
    )
}


def band(name: str) -> Band:
    return BANDS[name]


def combine(a: Band, b: Band) -> Band:
    """Combine two bands into one wide band (gmtPhotometry.m:48-53
    `plus`): summed bandwidth and zero point, flux-weighted mean
    wavelength.  Documented deviation: the reference leaves the weighted
    wavelength UN-normalized (zp1*w1 + zp2*w2 with no division), which
    yields a wavelength ~1e12 m; here it is divided by the total zero
    point so the result is physically usable."""
    zp = a.zero_point + b.zero_point
    w = (a.zero_point * a.wavelength + b.zero_point * b.wavelength) / zp
    return Band(f"{a.name}+{b.name}", w, a.bandwidth + b.bandwidth, zp)


def wavelength_scale(from_band: Band, to_band: Band) -> float:
    """Phase rescale factor between bands (telescopeAbstract.m:490)."""
    return from_band.wavelength / to_band.wavelength


def rad_to_nm(wavelength: float) -> float:
    """[rad] -> [nm] of optical path (README.md:373)."""
    return wavelength / (2.0 * math.pi) * 1e9
