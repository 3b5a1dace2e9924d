"""Excursion-tail experiment at flagship scale (port of the repository's
``benchmarks/excursion_tail.py``).

The tuned D/r0 >= 15 rows hold a high MEAN Strehl but take deep
self-recovering excursions.  MODES found that a higher modal order needs
var_max_radius=0.85 (the plain order-14 VAR sits at companion radius
~0.996 and collapses); this tests whether that recipe -- order 14 + VAR
clamp + mmse shrinkage + warm start -- cuts the excursion TAIL (min and
p5 Strehl, p95 residual, time under Strehl 0.5) at R=512, D/r0 in
{15, 20}, against the order-10 tuned recipe.  Both arms share
protocol_sweep's protocol: at XT_TRAIN=1000 (n_valid 50) the order-10
arm is protocol_sweep's tuned row at PROTO_TRAIN=1000.

The measurement noise comes from a torch generator seeded 1 (the JAX
PRNGKey(1) stream cannot be reproduced); the screens are the JAX
package's.

Usage: python -m mpc_sensorlessao_tpu_torch.benchmarks.excursion_tail
       [resolution] [out.json]
Env:   XT_DR0=15,20  XT_STEPS=500  XT_TRAIN=1000 (n_valid max(50, n/20))
       XT_DEVICE=cuda (the card unless "cpu" is named)
With out.json given and holding a report of the same device,
resolution, steps and XT_TRAIN, its rows are kept and only the missing
arms run (resume); another report's rows are not merged.  The
report is printed, and written only to the out.json given.
"""

from __future__ import annotations

import json
import os
import sys

from ..utils.config import SystemConfig
from . import _protocol as P
from .protocol_sweep import run_tuned, tuned_build

# (arm, radial order, VAR companion-radius clamp)
ARMS = (("order10", 10, None), ("order14_clamp", 14, 0.85))


def base_cfg(resolution: int, env) -> SystemConfig:
    """reference_config(resolution) with XT_TRAIN's split (n_valid
    max(50, n // 20)) and XT_STEPS closed-loop steps."""
    n_tr = P.env_int(env, "XT_TRAIN")
    return P.protocol_cfg(resolution, P.env_int(env, "XT_STEPS"),
                          n_train=n_tr,
                          n_valid=max(50, n_tr // 20) if n_tr else 50)


def arm_row(cfg0: SystemConfig, d: float, order: int,
            var_max_radius: float | None, dev) -> dict:
    """Build one arm (the tuned recipe at D/r0 = d, radial order
    ``order``, the VAR clamp) and run it from the warm start (noise seed
    1).  Returns its tail row."""
    cfg, system, build_s = tuned_build(cfg0, d, dev, order, var_max_radius)
    out, loop_s = run_tuned(cfg, system, dev)
    row = P.tail_row(out)
    row["build_s"] = round(build_s, 1)
    row["loop_s"] = round(loop_s, 2)
    return row


def verdict(a: dict, b: dict) -> dict:
    """Did the clamped order-14 arm (b) cut the order-10 arm's (a) tail:
    a higher min Strehl and a lower p95 residual?"""
    return {
        "min_strehl": [a["min_strehl"], b["min_strehl"]],
        "p95_rms": [a["p95_rms_res_rad"], b["p95_rms_res_rad"]],
        "improved": bool(b["min_strehl"] > a["min_strehl"]
                         and b["p95_rms_res_rad"] < a["p95_rms_res_rad"]),
    }


def main(argv=None, env=None) -> dict:
    """Run every missing arm; returns the report, prints it, and writes it
    to the out.json argument when one is given."""
    argv = sys.argv[1:] if argv is None else list(argv)
    env = os.environ if env is None else env
    res = int(argv[0]) if argv else 512
    out_path = argv[1] if len(argv) > 1 else None
    dev = P.device(env, "XT_DEVICE")
    d_grid = [float(d) for d in env.get("XT_DR0", "15,20").split(",")]
    cfg0 = base_cfg(res, env)

    report = {
        "what": ("Order-14 + var_max_radius=0.85 (MODES_r04 recipe) vs "
                 "the shipped order-10 tuned recipe at flagship scale: "
                 "does the excursion tail shrink at d>=15?"),
        "resolution": res, "n_steps": cfg0.sim.n_test,
        "n_train": cfg0.sim.n_train,
        "device": P.device_name(dev), "rows": {},
    }
    P.load_report(out_path, report, ("rows",),
                  knobs=("resolution", "n_steps", "n_train"))

    for d in d_grid:
        for arm, order, vmr in ARMS:
            key = f"d={d:g}_{arm}"
            if key in report["rows"]:
                continue
            row = arm_row(cfg0, d, order, vmr, dev)
            report["rows"][key] = row
            print(json.dumps({key: row}), file=sys.stderr, flush=True)
            P.save_report(report, out_path)

    for d in d_grid:
        a = report["rows"].get(f"d={d:g}_order10")
        b = report["rows"].get(f"d={d:g}_order14_clamp")
        if a and b:
            report[f"d={d:g}_tail_verdict"] = verdict(a, b)

    P.save_report(report, out_path)
    print(json.dumps(report, indent=2))
    return report


if __name__ == "__main__":
    main()
