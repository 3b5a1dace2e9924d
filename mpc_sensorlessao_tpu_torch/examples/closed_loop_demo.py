"""End-to-end sensorless-AO MPC demo (port of the repository's
``examples/closed_loop_demo.py``; the reference main.mlx workflow).

Builds the full pipeline, runs the closed loop and prints the settled
metrics.  At D/r0 >= 10 it takes the strong-turbulence recipe.

    python -m mpc_sensorlessao_tpu_torch.examples.closed_loop_demo
        [resolution] [d_over_r0] [cpu]

``main`` returns the metrics as a dict.
"""

from __future__ import annotations

import dataclasses
import sys

import torch

from ..models import pipeline
from ..utils import metrics
from ..utils.config import reference_config


def demo_cfg(resolution: int = 64, d_over_r0: float = 5.0,
             n_test: int = 100):
    """The JAX demo's configuration (n_train 300, n_valid 50)."""
    cfg = reference_config(resolution=resolution)
    cfg = cfg.replace(sim=dataclasses.replace(
        cfg.sim, n_train=300, n_valid=50, n_test=n_test,
        d_over_r0=d_over_r0))
    if d_over_r0 >= 10:   # strong-turbulence recipe (README "Beyond parity")
        cfg = cfg.replace(
            zernike=dataclasses.replace(cfg.zernike, radial_order=10),
            mpc=dataclasses.replace(cfg.mpc, warm_start=True,
                                    var_ridge=1e-2, r_weight=30.0),
            estimator=dataclasses.replace(
                cfg.estimator, method="mmse",
                prior_scale=min(0.15, 0.5 / d_over_r0)))
    return cfg


def main(device: torch.device | str = "cuda", resolution: int = 64,
         d_over_r0: float = 5.0, n_test: int = 100) -> dict:
    cfg = demo_cfg(resolution, d_over_r0, n_test)
    print(f"Building pipeline (R={resolution}, D/r0={d_over_r0}) ...")
    system = pipeline.build(cfg, device)
    print(f"  atmosphere: seeing {cfg.atmosphere.seeing_arcsec:.2f}\", "
          f"tau0 {cfg.atmosphere.tau0_ms:.1f} ms, "
          f"Greenwood {cfg.atmosphere.greenwood_frequency:.1f} Hz")
    print("Running the 200 Hz closed loop ...")
    gen = torch.Generator(device=device)
    gen.manual_seed(1)
    out = pipeline.run_closed_loop(system, cfg, gen)
    summary = metrics.to_dict(metrics.summarize(out))
    for k, v in summary.items():
        print(f"  {k:>22s}: {v:.4f}")
    return summary


if __name__ == "__main__":
    a = sys.argv[1:]
    main(a[2] if len(a) > 2 else "cuda", int(a[0]) if a else 64,
         float(a[1]) if len(a) > 1 else 5.0)
