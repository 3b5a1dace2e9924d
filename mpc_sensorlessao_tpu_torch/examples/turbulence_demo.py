"""Turbulence statistics demo: synthesized screens vs analytics (port of
the repository's ``examples/turbulence_demo.py``).

Synthesizes Von Karman screens (numpy-seeded, so the JAX demo's screens),
holds their structure function against phase_stats, and prints the Noll
residual-variance ladder and the tip-tilt image motion.  Host numpy.

    python -m mpc_sensorlessao_tpu_torch.examples.turbulence_demo

``main`` returns the printed numbers as a dict.
"""

from __future__ import annotations

import numpy as np

from ..ops import phase_screens, phase_stats
from ..ops import zernike_stats as zs
from ..utils.config import AtmosphereConfig, TelescopeConfig


def main(n_screens: int = 80, resolution: int = 64) -> dict:
    atm = AtmosphereConfig(fractional_r0=(1.0,), altitudes=(0.0,),
                           wind_speeds=(5.0,), wind_directions=(0.0,))
    tel = TelescopeConfig(resolution=resolution)
    R, pitch = resolution, tel.pixel_pitch

    print("Empirical vs analytic phase structure function:")
    seps = [2, 8, 24]
    acc = np.zeros(len(seps))
    for s in range(n_screens):
        scr = phase_screens.synthesize_screen(s, atm, R, pitch)[:R, :R]
        for i, dpx in enumerate(seps):
            acc[i] += np.mean((scr[:, dpx:] - scr[:, :-dpx]) ** 2) / n_screens
    out = {"structure_function": {}}
    for i, dpx in enumerate(seps):
        an = float(phase_stats.structure_function(dpx * pitch, atm))
        out["structure_function"][dpx] = {"empirical": float(acc[i]),
                                          "analytic": an}
        print(f"  sep {dpx*pitch:.3f} m: D_emp {acc[i]:7.3f}  "
              f"D_analytic {an:7.3f}  ratio {acc[i]/an:.3f}")

    print("\nNoll residual-variance ladder (D/r0=1, Kolmogorov):")
    atm_k = AtmosphereConfig(r0=1.0, L0=1e6, fractional_r0=(1.0,),
                             altitudes=(0.0,), wind_speeds=(5.0,),
                             wind_directions=(0.0,))
    out["residual_variance"] = {}
    for j in (1, 3, 6, 10, 21):
        v = zs.residual_variance(j, atm_k, 1.0)
        out["residual_variance"][j] = v
        print(f"  Delta_{j:<2d} = {v:.4f} rad^2")

    tt = float(zs.rms_arcsec(atm, 1.0, zs.variance_analytic(atm, 1.0, 1)[1]))
    out["tip_tilt_arcsec"] = tt
    print(f"\nTip-tilt image motion: {tt:.3f} arcsec rms")
    return out


if __name__ == "__main__":
    main()
