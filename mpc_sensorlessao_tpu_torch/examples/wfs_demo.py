"""Wavefront-sensing demo: SH camera chain, slopes-MMSE, tomography (port of
the repository's ``examples/wfs_demo.py``).

Shack-Hartmann spots through the detector chain, spatial MMSE
reconstruction, and a 3-guide-star tomographic estimate.  The screen is
numpy-seeded (the JAX demo's), so the geometric slopes, the slopes-MMSE
map and the tomography numbers are deterministic; the camera chain draws
its photon and readout noise from a torch generator seeded 0.

    python -m mpc_sensorlessao_tpu_torch.examples.wfs_demo [cpu]

``main`` returns the printed numbers as a dict.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ..models import imaging, slopes_mmse, tomography, wfs
from ..ops import phase_screens
from ..utils.config import AtmosphereConfig, TelescopeConfig

ARCSEC = np.pi / 180 / 3600
R, NL = 80, 10


def main(device: torch.device | str = "cuda") -> dict:
    atm = AtmosphereConfig(fractional_r0=(1.0,), altitudes=(0.0,),
                           wind_speeds=(5.0,), wind_directions=(0.0,))
    tel = TelescopeConfig(resolution=R)
    sh = wfs.build(R, n_lenslet=NL, device=device)
    scr = phase_screens.synthesize_screen(7, atm, R,
                                          tel.pixel_pitch)[:R, :R] * 0.3
    ph = torch.as_tensor(np.asarray(scr - scr.mean(), dtype=np.float32),
                         device=device)

    det = imaging.DetectorConfig(resolution=sh.dft_op.shape[0],
                                 photon_noise=True, read_out_noise=2.0)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    geo = wfs.geometric_slopes(sh, ph)
    cam = wfs.camera_slopes(sh, ph, gen, detector=det, n_photons=500.0,
                            threshold=(6.0, 0.2),
                            ref_slopes=wfs.reference_slopes(sh))
    out = {"camera_slope_error": float(torch.sqrt(torch.mean(
               (cam - geo) ** 2))),
           "slope_signal": float(torch.sqrt(torch.mean(geo ** 2)))}
    print(f"SH camera chain: slope error {out['camera_slope_error']:.4f} "
          f"rad/px (signal {out['slope_signal']:.4f})")

    model = slopes_mmse.build(atm, tel.diameter, NL, sh.valid,
                              noise_var=(0.02 / tel.pixel_pitch) ** 2,
                              device=device)
    phi = slopes_mmse.reconstruct(model, geo, tel.pixel_pitch)
    # jnp.std: the population standard deviation
    out["mmse_rms"] = float(torch.std(phi, correction=0))
    print(f"slopes-MMSE phase map: {tuple(phi.shape)}, "
          f"rms {out['mmse_rms']:.3f} rad")

    atm_h = AtmosphereConfig(fractional_r0=(1.0,), altitudes=(8000.0,),
                             wind_speeds=(5.0,), wind_directions=(0.0,))
    th = 15 * ARCSEC
    gs = [(th, 0.0), (-th / 2, th * 0.866), (-th / 2, -th * 0.866)]
    tomo = tomography.build(atm_h, 1.0, 4, gs, device=device)
    out["tomography_error_rad2"] = tomo.err_var_rad2
    out["tomography_strehl"] = tomo.strehl_marechal
    print(f"3-GS tomography (15\" triangle, 8 km layer): predicted "
          f"error {tomo.err_var_rad2:.3f} rad^2, "
          f"Strehl {tomo.strehl_marechal:.3f}")
    return out


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "cuda")
