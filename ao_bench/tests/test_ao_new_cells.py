"""The cell ``modes14n32.shared`` rehearsed on the CPU: the result line,
``correct`` and no diverged scenario.

The rehearsal keeps radial order 14 and N=32 (only the grid, the split,
the batch and the episode are cut), so the reference forms its dense
12224-square KKT inverse here too (~30 s in all).
"""

import json
import subprocess
import sys

from conftest import ROOT

REQUIRED = ["correct", "attempted", "failed", "metrics", "device"]


def test_modes14n32_rehearses_correct():
    proc = subprocess.run(
        [sys.executable, "ao_bench/run.py", "--workload", "modes14n32.shared",
         "--seed", str(2 ** 31 + 29), "--seconds", "0.3", "--trace", "0",
         "--rehearse"], capture_output=True, text=True, cwd=ROOT,
        timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert list(res)[:5] == REQUIRED and list(res)[-1] == "checks"
    assert res["correct"] is True, res["checks"]
    assert res["attempted"] > 0 and res["attempted"] % 8 == 0
    assert res["failed"] == 0
    assert res["device"]["platform"] == "cpu"
    assert set(res["metrics"]) == {"rehearsal.solves_per_s",
                                   "rehearsal.settled_strehl",
                                   "rehearsal.setup_s"}
