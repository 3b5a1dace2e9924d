"""Import guard: the harness loads neither JAX nor the JAX package, and
the reference loads nothing of the port either.  Each check runs in a
fresh interpreter and compares top-level module names whole (the port's
name begins with the JAX package's)."""

import json
import subprocess
import sys

import pytest

from conftest import ROOT

JAX = ("jax", "jaxlib", "flax", "mpc_sensorlessao_tpu")

PROBE = """
import json, sys
sys.path.insert(0, {root!r})
for name in {mods!r}:
    __import__(name)
for path in {readers!r}:
    from ao_bench import harness
    harness.load_reader(path)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def loaded(mods, readers=()) -> set:
    code = PROBE.format(root=str(ROOT), mods=list(mods), readers=list(readers))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=ROOT)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_loads_no_jax():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    top = loaded(["ao_bench.run", "ao_bench.harness", "ao_bench.check",
                  "ao_bench.trace", "ao_bench.yardstick",
                  "ao_bench.reference.system",
                  "mpc_sensorlessao_tpu_torch.models.pipeline",
                  "mpc_sensorlessao_tpu_torch.parallel.montecarlo"], names)
    assert not top & set(JAX), sorted(top & set(JAX))
    assert "mpc_sensorlessao_tpu_torch" in top


def test_reference_loads_nothing_of_the_port():
    top = loaded(["ao_bench.reference.system"])
    assert not top & {*JAX, "mpc_sensorlessao_tpu_torch"}


def test_reference_sources_name_no_program():
    for path in (ROOT / "ao_bench" / "reference").glob("*.py"):
        text = path.read_text()
        for name in ("import jax", "mpc_sensorlessao_tpu"):
            assert name not in text, f"{path.name} names {name}"


def test_nothing_loads_the_old_benchmarks():
    """Neither the root ``benchmarks/`` nor ``bench.py``, nor the port's
    own benchmark scripts, are loaded by a run."""
    mods = ["ao_bench.run", "ao_bench.harness",
            "mpc_sensorlessao_tpu_torch.models.pipeline",
            "mpc_sensorlessao_tpu_torch.models.estimator",
            "mpc_sensorlessao_tpu_torch.ops.psf_kernels",
            "mpc_sensorlessao_tpu_torch.parallel.montecarlo"]
    code = PROBE.format(root=str(ROOT), mods=mods, readers=[]).replace(
        '{m.split(".")[0] for m in sys.modules}', "set(sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=ROOT)
    mods = json.loads(out.stdout.strip().splitlines()[-1])
    bad = [m for m in mods if m.split(".")[0] in ("benchmarks", "bench")
           or m.startswith("mpc_sensorlessao_tpu_torch.benchmarks")]
    assert not bad, bad


@pytest.mark.parametrize("argv", [
    ["--workload", "ref512.shared", "--seed", "1", "--seconds", "1",
     "--trace", "0"],
])
def test_run_without_a_card_gives_no_result(argv):
    pytest.importorskip("torch")
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, "ao_bench/run.py", *argv],
                         capture_output=True, text=True, cwd=ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr
