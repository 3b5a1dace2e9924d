"""Mode/horizon sweep demo + telemetry display (port of the repository's
``examples/horizon_sweep_demo.py``; BASELINE config 3 mini).

Builds one system, sweeps the MPC horizon through
``pipeline.with_horizon`` (the expensive layers are horizon-independent),
prints a settled-metrics table and, given a path, writes the last run's
closed-loop telemetry PNG with ``utils/display.py``.

    python -m mpc_sensorlessao_tpu_torch.examples.horizon_sweep_demo
        [resolution] [radial_order] [cpu] [telemetry.png]

``main`` returns {horizon: {"rms_res", "rejection", "strehl"}}.
"""

from __future__ import annotations

import dataclasses
import sys

import torch

from ..models import pipeline
from ..utils.config import reference_config

SETTLE = 20        # steps dropped before the settled means


def demo_cfg(resolution: int = 64, order: int = 6, n_test: int = 40):
    """The JAX demo's configuration."""
    cfg = reference_config(resolution=resolution)
    return cfg.replace(
        zernike=dataclasses.replace(cfg.zernike, radial_order=order),
        mpc=dataclasses.replace(cfg.mpc, var_ridge=1e-2,
                                var_max_radius=0.85, warm_start=True,
                                r_weight=30.0),
        sim=dataclasses.replace(cfg.sim, n_train=300, n_valid=50,
                                n_test=n_test))


def main(device: torch.device | str = "cuda", resolution: int = 64,
         order: int = 6, horizons=(2, 8, 16), n_test: int = 40,
         save: str | None = None) -> dict:
    cfg = demo_cfg(resolution, order, n_test)
    system = pipeline.build(cfg, device)
    n_modes = (order + 1) * (order + 2) // 2
    print(f"built: {n_modes} modes (radial order {order}), R={resolution}")
    print(f"{'N':>4} {'rms_res':>9} {'rejection':>10} {'strehl':>8}")
    rows, last = {}, None
    for N in horizons:
        cfg_n = cfg.replace(mpc=dataclasses.replace(cfg.mpc, horizon=N))
        sys_n = pipeline.with_horizon(system, cfg_n)
        gen = torch.Generator(device=device)
        gen.manual_seed(1)
        out = pipeline.run_closed_loop(sys_n, cfg_n, gen)
        res = float(out.rms_res[SETTLE:].mean())
        turb = float(out.rms_turb[SETTLE:].mean())
        strehl = float(out.strehl_exact[SETTLE:].mean())
        rows[N] = {"rms_res": res, "rejection": turb / res,
                   "strehl": strehl}
        print(f"{N:>4} {res:>9.4f} {turb / res:>10.2f} {strehl:>8.4f}")
        last = out
    if save is not None:
        from ..utils import display
        display.show_telemetry(last, save=save, close=True)
        print(f"telemetry PNG written to {save}")
    return rows


if __name__ == "__main__":
    a = sys.argv[1:]
    main(a[2] if len(a) > 2 else "cuda", int(a[0]) if a else 64,
         int(a[1]) if len(a) > 1 else 6, save=a[3] if len(a) > 3 else None)
