"""The JAX demos' numbers, for the port's demos to be held to.

``examples/wfs_demo.py`` and ``examples/mcao_demo.py`` print rounded
numbers and return nothing, so the functions here run the same JAX calls
on the same inputs and return them at full precision.  The machine with
the card has no JAX, so the deterministic ones are recorded once, on the
CPU, in the port's package:

    python tests/torch_demo_support.py

writes ``mpc_sensorlessao_tpu_torch/examples/demo_reference.json``, which
``chip_smoke.py`` (the ``a12`` phase) and tests/test_torch_demos.py read.
"""

import json
import os
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

jax.config.update("jax_platforms", "cpu")
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from mpc_sensorlessao_tpu.models import imaging, mcao, slopes_mmse  # noqa
from mpc_sensorlessao_tpu.models import tomography, wfs  # noqa: E402
from mpc_sensorlessao_tpu.ops import phase_screens, relay, zernike  # noqa
from mpc_sensorlessao_tpu.ops import zernike_stats as zs  # noqa: E402
from mpc_sensorlessao_tpu.utils.config import (  # noqa: E402
    AtmosphereConfig, TelescopeConfig)

ARCSEC = np.pi / 180 / 3600
REFERENCE = (Path(__file__).resolve().parents[1] / "mpc_sensorlessao_tpu_torch"
             / "examples" / "demo_reference.json")


def wfs_numbers() -> dict:
    """examples/wfs_demo.py:34-66, every printed number."""
    atm = AtmosphereConfig(fractional_r0=(1.0,), altitudes=(0.0,),
                           wind_speeds=(5.0,), wind_directions=(0.0,))
    tel = TelescopeConfig(resolution=80)
    sh = wfs.build(80, n_lenslet=10)
    scr = np.asarray(phase_screens.synthesize_screen(
        7, atm, 80, tel.pixel_pitch))[:80, :80] * 0.3
    ph = jnp.asarray(scr - scr.mean(), jnp.float32)
    det = imaging.DetectorConfig(resolution=sh.dft_op.shape[1],
                                 photon_noise=True, read_out_noise=2.0)
    geo = np.asarray(wfs.geometric_slopes(sh, ph))
    cam = np.asarray(wfs.camera_slopes(
        sh, ph, jax.random.PRNGKey(0), detector=det, n_photons=500.0,
        threshold=(6.0, 0.2), ref_slopes=wfs.reference_slopes(sh)))
    model = slopes_mmse.build(atm, tel.diameter, 10, sh.valid,
                              noise_var=(0.02 / tel.pixel_pitch) ** 2)
    phi = slopes_mmse.reconstruct(model, jnp.asarray(geo), tel.pixel_pitch)
    atm_h = AtmosphereConfig(fractional_r0=(1.0,), altitudes=(8000.0,),
                             wind_speeds=(5.0,), wind_directions=(0.0,))
    th = 15 * ARCSEC
    gs = [(th, 0.0), (-th / 2, th * 0.866), (-th / 2, -th * 0.866)]
    tomo = tomography.build(atm_h, 1.0, 4, gs)
    return {"camera_slope_error": float(np.sqrt(np.mean((cam - geo) ** 2))),
            "slope_signal": float(np.sqrt(np.mean(geo ** 2))),
            "mmse_rms": float(jnp.std(phi)),
            "tomography_error_rad2": float(tomo.err_var_rad2),
            "tomography_strehl": float(tomo.strehl_marechal)}


def mcao_numbers(n_mc: int = 60) -> dict:
    """examples/mcao_demo.py:35-95, every printed number."""
    atm = AtmosphereConfig(fractional_r0=(0.6, 0.4),
                           altitudes=(0.0, 8000.0), wind_speeds=(5.0, 5.0),
                           wind_directions=(0.0, 0.0))
    th = 10 * ARCSEC
    gs = [(th, 0.0), (-th / 2, th * 0.866), (-th / 2, -th * 0.866)]
    sci = [(0.0, 0.0), (th, 0.0)]
    fov, order, D = 4.0 * th, 3, 1.0
    one = mcao.build(atm, D, fov, [mcao.DMLayer(0.0, order)], order, gs,
                     sci)
    two = mcao.build(atm, D, fov,
                     [mcao.DMLayer(0.0, order),
                      mcao.DMLayer(8000.0, order, skip_modes=3)],
                     order, gs, sci)
    out = {"piston_free_var_rad2": two.piston_free_var_rad2,
           "scao_var_rad2": two.scao_var_rad2}
    for key, m in (("one_dm", one), ("two_dm", two)):
        out[key] = {"mcao_var_rad2": m.mcao_var_rad2,
                    "target_vars_rad2": np.asarray(
                        m.target_vars_rad2).tolist()}
    R, pitch = 48, D / 47
    basis = zernike.make_basis(order, R)
    npix = jnp.sum(basis.mask.astype(jnp.float32))
    Nf = zs.norm_factors(order)[1:]
    dirs = list(sci) + list(gs)

    @jax.jit
    def all_coeffs(scr0, scr1):
        def c_of(ph):
            p2 = zernike.piston_removed_phase_masked(ph, basis.mask, npix)
            return (basis.fit_full @ p2.reshape(-1))[1:]
        return jnp.stack([c_of(relay.project_layers(
            [scr0, scr1], [pitch, pitch], D / 2, atm.altitudes, R,
            direction=d)) for d in dirs])

    resid = []
    for s in range(n_mc):
        scr0 = jnp.asarray(np.asarray(phase_screens.synthesize_screen(
            2 * s, atm.layer(0), 192, pitch, oversample=1)))
        scr1 = jnp.asarray(np.asarray(phase_screens.synthesize_screen(
            2 * s + 1, atm.layer(1), 192, pitch, oversample=1)))
        c = np.asarray(all_coeffs(scr0, scr1)) / Nf[None, :]
        u = np.asarray(mcao.correct(
            two, jnp.asarray(c[len(sci):], jnp.float32)))
        resid.append([float(np.sum(
            (c[k] - np.asarray(mcao.correction_coeffs(two, u, k))) ** 2))
            for k in range(len(sci))])
    out["monte_carlo_rad2"] = np.mean(np.asarray(resid), axis=0).tolist()
    out["predicted_rad2"] = (np.asarray(two.target_vars_rad2)
                             - two.scao_var_rad2).tolist()
    return out


def main() -> None:
    ref = {"source": "examples/wfs_demo.py and examples/mcao_demo.py, "
                     "recomputed at full precision by "
                     "tests/torch_demo_support.py on the CPU",
           "jax": jax.__version__,
           "wfs": wfs_numbers(), "mcao": mcao_numbers()}
    REFERENCE.write_text(json.dumps(ref, indent=1) + "\n")
    print(REFERENCE.read_text())


if __name__ == "__main__":
    main()
