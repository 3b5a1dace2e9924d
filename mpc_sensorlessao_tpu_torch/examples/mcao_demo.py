"""Multi-conjugate AO demo: tomographic multi-DM correction (port of the
repository's ``examples/mcao_demo.py``; OOMAO's modalMCAO.m pipeline).

A 3 guide-star asterism over a two-layer atmosphere drives one or two
Zernike deformable mirrors (ground + 8 km conjugate) through the
field-averaged MMSE command matrix; analytic residual variances are
reported for the on-axis and off-axis science directions and checked by
a Monte-Carlo over numpy-seeded layered screens, all screens as one
batch: relay.project_layers -> piston_removed_phase_masked -> fit_full ->
mcao.correct -> correction_coeffs.

    python -m mpc_sensorlessao_tpu_torch.examples.mcao_demo [cpu] [n_mc]

``main`` returns the printed numbers as a dict.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ..models import mcao
from ..ops import phase_screens, relay, zernike
from ..ops import zernike_stats as zs
from ..utils.config import AtmosphereConfig

ARCSEC = np.pi / 180 / 3600


def monte_carlo(model: mcao.ModalMCAO, atm: AtmosphereConfig, dirs,
                n_sci: int, order: int, n_mc: int, device,
                R: int = 48, D: float = 1.0, n_screen: int = 192
                ) -> np.ndarray:
    """(n_mc, n_sci) modeled-mode residual [rad^2] of ``model`` over n_mc
    screen pairs (seeds 2s, 2s+1) seen in ``dirs`` (science first, then
    the guide stars), in one batch."""
    pitch = D / (R - 1)
    basis = zernike.make_basis(order, R, device=device)
    npix = torch.sum(basis.mask.to(torch.float32))
    Nf = zs.norm_factors(order)[1:]
    scr = [torch.as_tensor(np.stack([phase_screens.synthesize_screen(
        2 * s + k, atm.layer(k), n_screen, pitch, oversample=1)
        for s in range(n_mc)]), device=device) for k in range(2)]
    ph = torch.stack([relay.project_layers(
        scr, [pitch, pitch], D / 2, atm.altitudes, R, direction=d)
        for d in dirs], dim=1)                       # (n_mc, n_dir, R, R)
    p2 = zernike.piston_removed_phase_masked(ph, basis.mask, npix)
    c = (p2.reshape(*p2.shape[:2], R * R) @ basis.fit_full.T)[..., 1:]
    c = c.double() / torch.as_tensor(Nf, device=device)
    u = mcao.correct(model, c[:, n_sci:].float())
    return np.stack([npy(torch.sum((c[:, k] - mcao.correction_coeffs(
        model, u, k).double()) ** 2, dim=-1)) for k in range(n_sci)], 1)


def npy(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def main(device: torch.device | str = "cuda", n_mc: int = 60) -> dict:
    atm = AtmosphereConfig(fractional_r0=(0.6, 0.4),
                           altitudes=(0.0, 8000.0),
                           wind_speeds=(5.0, 5.0),
                           wind_directions=(0.0, 0.0))
    th = 10 * ARCSEC
    gs = [(th, 0.0), (-th / 2, th * 0.866), (-th / 2, -th * 0.866)]
    sci = [(0.0, 0.0), (th, 0.0)]
    fov, order, D = 4.0 * th, 3, 1.0

    one = mcao.build(atm, D, fov, [mcao.DMLayer(0.0, order)],
                     order, gs, sci, device=device)
    two = mcao.build(atm, D, fov,
                     [mcao.DMLayer(0.0, order),
                      mcao.DMLayer(8000.0, order, skip_modes=3)],
                     order, gs, sci, device=device)

    print(f"piston-free turbulence variance: "
          f"{two.piston_free_var_rad2:.3f} rad^2")
    print(f"ideal on-axis SCAO (order {order}):  "
          f"{two.scao_var_rad2:.3f} rad^2")
    out = {"piston_free_var_rad2": two.piston_free_var_rad2,
           "scao_var_rad2": two.scao_var_rad2}
    for key, name, m in (("one_dm", "1 DM (ground)", one),
                         ("two_dm", "2 DM (0 + 8 km)", two)):
        t = ", ".join(f"{v:.3f}" for v in m.target_vars_rad2)
        print(f"{name:16s} field-avg {m.mcao_var_rad2:.3f} rad^2, "
              f"per-direction [{t}] (on-axis, 10\")")
        out[key] = {"mcao_var_rad2": m.mcao_var_rad2,
                    "target_vars_rad2": m.target_vars_rad2.tolist()}

    resid = monte_carlo(two, atm, list(sci) + list(gs), len(sci), order,
                        n_mc, device)
    mc = resid.mean(axis=0)
    pred = two.target_vars_rad2 - two.scao_var_rad2
    print(f"Monte-Carlo modeled-mode residual ({n_mc} screens): "
          f"[{mc[0]:.3f}, {mc[1]:.3f}] rad^2 "
          f"(predicted [{pred[0]:.3f}, {pred[1]:.3f}])")
    out["monte_carlo_rad2"] = mc.tolist()
    out["predicted_rad2"] = pred.tolist()
    return out


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "cuda",
         int(sys.argv[2]) if len(sys.argv) > 2 else 60)
