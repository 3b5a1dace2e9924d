"""Run one cell of the port's benchmark.

    python3 ao_bench/run.py --workload ref512.shared --seed 7 \
        --seconds 30 --trace 0

prints one JSON result line last on stdout: ``correct``, ``attempted``
(scenario episodes run), ``failed`` (of them, diverged), ``metrics``
(the cell's end-to-end metrics, or with ``--trace 1`` its per-layer
ones), ``device``, with ``--trace 1`` the ``breakdown`` of the traced
episode, and last ``checks``: each number compared with the reference,
beside its limit (also the last lines of standard error).

Needs a CUDA card; without one it exits 1 and prints no result.  Two
options serve the harness's own tests and the choice of its limits:
``--rehearse`` runs the cell cut to a tiny size on the CPU (its metrics
are prefixed ``rehearsal.`` and name no device number), and
``--control tf32`` puts the reference, computed in TF32, in the
program's place.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
# build and kernel caches at fixed paths inside the checkout
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton")):
    os.environ.setdefault(var, str(ROOT / "build" / sub))


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--rehearse", action="store_true")
    ap.add_argument("--control", choices=("tf32",), default=None)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    import torch
    from ao_bench import harness

    def log(msg):
        print(msg, file=sys.stderr, flush=True)

    cell = harness.Cell(args.workload)
    if args.rehearse:
        cell.rehearse()
        device = torch.device("cpu")
    else:
        need = cell.entry["chips"]
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if found < need:
            log(f"{args.workload} needs {need} CUDA card(s); found {found}")
            return 1
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
    # TF32 stays off for the program; the control rounds its operands
    # to TF32 itself, and the tensor cores then give its exact products
    torch.backends.cuda.matmul.allow_tf32 = args.control == "tf32"
    torch.backends.cudnn.allow_tf32 = False
    try:
        result = harness.run(cell, args.seed, args.seconds, bool(args.trace),
                             device, T_START, control=args.control, log=log)
    except harness.BenchError as err:
        log(f"no result: {err}")
        return 1
    if args.rehearse:
        result["metrics"] = {f"rehearsal.{k}": v
                             for k, v in result["metrics"].items()}
    for name, c in result["checks"].items():
        log(f"check {name} = {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
