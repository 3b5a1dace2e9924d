"""The harness end to end on the CPU at the rehearsal's tiny size: the
result line, the faults that must turn ``correct`` false, the JAX guard,
a cell added as data alone, and a checkout that lacks the program."""

import json
import shutil
import subprocess
import sys
import time
import types

import pytest
import torch

from conftest import ROOT
from ao_bench import harness

REQUIRED = ["correct", "attempted", "failed", "metrics", "device"]
CELLS = ["ref512.shared", "strong512.shared", "ref512.decorrelated"]


def rehearse(workload, seed, trace=0, cwd=ROOT, env=None):
    return subprocess.run(
        [sys.executable, "ao_bench/run.py", "--workload", workload,
         "--seed", str(seed), "--seconds", "0.3", "--trace", str(trace),
         "--rehearse"], capture_output=True, text=True, cwd=cwd, env=env,
        timeout=900)


def last_line(proc) -> dict:
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("workload", CELLS)
def test_rehearsal_prints_the_result_line(workload):
    res = last_line(rehearse(workload, 2 ** 31 + 17))
    keys = list(res)
    assert keys[:5] == REQUIRED and keys[-1] == "checks"
    assert set(keys) == {*REQUIRED, "checks"}
    assert res["correct"] is True, res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert res["device"]["platform"] == "cpu"
    # no CPU number under a device metric's name
    assert all(k.startswith("rehearsal.") for k in res["metrics"])
    for c in res["checks"].values():
        assert set(c) == {"value", "limit"}


def test_traced_rehearsal_has_a_breakdown_and_no_device_metric():
    res = last_line(rehearse("ref512.shared", 5, trace=1))
    assert list(res)[-2:] == ["breakdown", "checks"]
    assert set(res["metrics"]) <= {"rehearsal.setup.build_s"}


def in_process(workload="ref512.shared", seed=3):
    cell = harness.Cell(workload)
    cell.rehearse()
    return harness.run(cell, seed, 0.2, False, torch.device("cpu"),
                       time.perf_counter(), log=lambda _: None)


def test_fault_state_left_unchanged(monkeypatch):
    """The solve returns its start: the command never moves."""
    from mpc_sensorlessao_tpu_torch.ops import newton_kkt

    def frozen(prob, op, x0, x0_pre, w, horizon):
        return newton_kkt.init_state(prob, horizon)._replace(
            U=torch.zeros((x0.shape[0], horizon, prob.B.shape[1])))
    monkeypatch.setattr(newton_kkt, "solve_fixed", frozen)
    res = in_process()
    assert res["correct"] is False
    assert res["checks"]["u_gap"]["value"] > res["checks"]["u_gap"]["limit"]


def test_fault_half_the_batch_left_out(monkeypatch):
    """Only the first half of the scenarios runs; the other half repeats
    it, so the batch's mean is the half's."""
    from mpc_sensorlessao_tpu_torch.parallel import montecarlo
    real = montecarlo.run_batch

    def half(models, layers, cfg, scen, n_steps, **kw):
        B = scen.mag.shape[0]
        out = real(models, layers, cfg, scen, n_steps,
                   rows=slice(0, B // 2), **kw)
        return type(out)(*(torch.cat([f, f]) for f in out))
    monkeypatch.setattr(montecarlo, "run_batch", half)
    assert in_process()["correct"] is False


def test_fault_answer_altered_where_produced(monkeypatch):
    """The measure kernel's PSF crops come out 0.1% too bright."""
    from mpc_sensorlessao_tpu_torch.ops import psf_kernels
    real = psf_kernels.psf_crop_diversity_sym3

    def bright(*a, **kw):
        return real(*a, **kw) * 1.001
    monkeypatch.setattr(psf_kernels, "psf_crop_diversity_sym3", bright)
    res = in_process()
    assert res["correct"] is False
    assert (res["checks"]["strehl_gap"]["value"]
            > res["checks"]["strehl_gap"]["limit"])


def test_jax_loaded_in_the_run_gives_no_result(monkeypatch):
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    with pytest.raises(harness.BenchError, match="jax"):
        in_process()


def copy_benchmark(tmp_path):
    dst = tmp_path / "ck"
    dst.mkdir()
    shutil.copy(ROOT / "BENCHMARK.json", dst)
    shutil.copytree(ROOT / "ao_bench", dst / "ao_bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    return dst


def test_a_cell_added_as_data_alone_runs(tmp_path):
    """A new traffic mix is one workload file and one BENCHMARK.json
    entry; no file the benchmark already has changes."""
    ck = copy_benchmark(tmp_path)
    before = {p: p.read_bytes() for p in (ck / "ao_bench").rglob("*")
              if p.is_file()}
    traffic = json.loads((ck / "ao_bench/workloads/ref512.shared.json")
                         .read_text())
    traffic.update(batch=16, snr_db=[20, 40], d_over_r0=[5, 10])
    traffic["rehearsal"] = {"batch": 8}
    (ck / "ao_bench/workloads/ref512.mixed.json").write_text(
        json.dumps(traffic))
    bench = json.loads((ck / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "ref512.mixed", "config": "ref512",
                               "traffic": "mixed", "chips": 1,
                               "why": "two D/r0 and two SNRs"})
    (ck / "BENCHMARK.json").write_text(json.dumps(bench))
    env = {"PYTHONPATH": str(ROOT), "PATH": "/usr/bin:/bin"}
    res = last_line(rehearse("ref512.mixed", 9, cwd=ck, env=env))
    assert res["correct"] is True and res["attempted"] % 8 == 0
    for p, data in before.items():
        assert p.read_bytes() == data


def test_a_checkout_of_the_benchmark_alone_gives_no_result(tmp_path):
    ck = copy_benchmark(tmp_path)
    proc = rehearse("ref512.shared", 1, cwd=ck, env={"PATH": "/usr/bin:/bin"})
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
