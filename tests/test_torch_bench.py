"""The port's torch bench (mpc_sensorlessao_tpu_torch/benchmarks/bench.py)
and its float64 oracle rows (benchmarks/oracle_reference_rows.py with
its copy of the NumPy oracle, benchmarks/_oracle_numpy.py) against the
repository's JAX ``bench.py`` and ``benchmarks/oracle_reference_rows.py``,
on the CPU.

* Configurations: each JAX script's SystemConfig, captured by replacing
  the JAX ``pipeline.build`` in-process (tests/torch_script_support.py),
  equals the port's under the same env.
* The bench on BENCH_DEVICE=cpu at R=32, B=2, 2 steps, 1 repeat: exactly
  one stdout line with the four keys of bench.py, the JAX meta keys on
  stderr, and a mean_strehl equal to run_batch's on the same build and
  scenarios.  (Without a card and without BENCH_DEVICE=cpu it raises:
  tests/test_torch_ops.py::test_builders_default_to_the_card.)
* The oracle: oracle_params of a port System carrying the JAX build's
  operators equals the JAX _oracle_params (float32 values, exactly); of
  the port's own build, within float32 rounding where the builds agree
  and within 2% of the scale where the JAX build fits its VAR model in
  float32 (the port in float64); the copied oracle equals
  tests/oracle_numpy.py bit for bit; the port's rows equal the JAX
  script's at R=32, 20 steps.
"""

import dataclasses
import json
import types

import jax
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import mpc_sensorlessao_tpu.models.pipeline as jpipeline
from mpc_sensorlessao_tpu.utils import config as jconfig
from mpc_sensorlessao_tpu_torch import interop
from mpc_sensorlessao_tpu_torch.benchmarks import _oracle_numpy
from mpc_sensorlessao_tpu_torch.benchmarks import _protocol as P
from mpc_sensorlessao_tpu_torch.benchmarks import bench
from mpc_sensorlessao_tpu_torch.benchmarks import oracle_reference_rows as orr
from mpc_sensorlessao_tpu_torch.models import pipeline, var
from mpc_sensorlessao_tpu_torch.parallel import montecarlo
from torch_script_support import _captured_cfg, _jax_script, _same

import oracle_numpy

torch.backends.cuda.matmul.allow_tf32 = False
# one intra-op thread a worker: the suite runs one file per worker
torch.set_num_threads(1)

SMALL = {"BENCH_RES": "32", "BENCH_BATCH": "2", "BENCH_STEPS": "2",
         "BENCH_REPEATS": "1"}
# the keys of bench.py's stdout line and stderr meta (bench.py:90-116)
LINE_KEYS = {"metric", "value", "unit", "vs_baseline"}
META_KEYS = {"build_s", "compile_s", "run_s", "resolution", "batch", "steps",
             "solver", "gauss_newton_iters", "device", "mean_strehl",
             "mean_strehl_marechal", "mean_rms_res"}
ORACLE_SMALL = {"ORACLE_RES": "32", "ORACLE_STEPS": "20",
                "ORACLE_TRAIN": "300"}


@pytest.fixture(autouse=True, scope="module")
def _one_blas_thread():
    """One BLAS thread a worker for numpy too: the suite runs one file per
    worker, and the float64 oracle's and the flow build's numpy solves
    oversubscribe the cores with BLAS's default threads."""
    with threadpool_limits(1):
        yield


@pytest.mark.parametrize("env", [{}, {
    "BENCH_RES": "32", "BENCH_STEPS": "7", "BENCH_DFT_DTYPE": "bfloat16",
    "BENCH_GN": "1"}], ids=["defaults", "knobs"])
def test_bench_config_equals_the_jax_bench(env, monkeypatch):
    for k in ("BENCH_RES", "BENCH_STEPS", "BENCH_DFT_DTYPE", "BENCH_GN"):
        monkeypatch.delenv(k, raising=False)
    jcfg = _captured_cfg(monkeypatch, "bench", [], env)
    _same(jcfg, bench.bench_cfg(int(env.get("BENCH_RES", "128")),
                                int(env.get("BENCH_STEPS", "25")),
                                env.get("BENCH_DFT_DTYPE", "float32"),
                                int(env.get("BENCH_GN", "0"))))


def test_bench_prints_one_line_and_the_jax_meta(capsys):
    line, meta = bench.main([], dict(SMALL, BENCH_DEVICE="cpu"))
    out, err = capsys.readouterr()
    lines = out.strip().splitlines()
    assert len(lines) == 1
    got = json.loads(lines[0])
    assert set(got) == LINE_KEYS and got == line
    assert got["metric"] == "mpc_control_steps_per_s"
    assert got["unit"] == "solves/s"
    # both rounded from the unrounded rate (bench.py:111-116)
    assert got["vs_baseline"] == pytest.approx(got["value"] / 200.0,
                                               abs=0.0051)
    printed = json.loads(err.strip().splitlines()[-1])
    assert META_KEYS <= set(printed) and printed == meta
    assert meta["device"] == "cpu"
    assert (meta["resolution"], meta["batch"], meta["steps"]) == (32, 2, 2)
    # the settled exact Strehl is run_batch's on the same build and batch
    cfg = bench.bench_cfg(32, 2, "float32", 0)
    system = pipeline.build(cfg, "cpu")
    scen = montecarlo.make_scenarios(
        cfg, torch.Generator().manual_seed(1), 2, d_over_r0_grid=(5.0,),
        snr_db_grid=(10.0,), device="cpu")
    ref = montecarlo.run_batch(system.loop, system.layers, cfg, scen, 2,
                               shared_window="verified")
    assert meta["mean_strehl"] == float(torch.mean(ref.strehl_exact[:, 1:]))
    assert np.isfinite(meta["mean_rms_res"]) and 0.5 < meta["mean_strehl"]


@pytest.mark.parametrize("env", [{}, ORACLE_SMALL],
                         ids=["defaults", "cut"])
def test_oracle_config_equals_the_jax_script(env, monkeypatch, tmp_path):
    for k in ORACLE_SMALL:
        monkeypatch.delenv(k, raising=False)
    jcfg = _captured_cfg(monkeypatch, "oracle_reference_rows",
                         [str(tmp_path / "o.json")], env)
    _same(jcfg, orr.oracle_cfg(int(env.get("ORACLE_RES", "512")),
                               int(env.get("ORACLE_TRAIN", "1000"))))


@pytest.fixture(scope="module")
def oracle_builds():
    """(cfg, JAX build, port build) of the oracle's cut at R=32."""
    cfg = orr.oracle_cfg(32, 300)
    jcfg = jconfig.reference_config(resolution=32)
    jcfg = jcfg.replace(sim=dataclasses.replace(jcfg.sim, n_train=300,
                                                n_valid=50))
    return (cfg, jcfg, jpipeline.build(jcfg, jax.random.PRNGKey(0)),
            pipeline.build(cfg, "cpu"))


def _jax_params(jcfg, jsys):
    mod = _jax_script("oracle_reference_rows")
    return mod._oracle_params(jcfg, jsys, "fastmpc")


def test_oracle_params_match_the_jax_build(oracle_builds):
    cfg, jcfg, jsys, psys = oracle_builds
    want = _jax_params(jcfg, jsys)
    # (a) the JAX build's operators carried across: the same float64 view
    # of the same float32 values
    loop = interop.loop_models_from_numpy(
        jax.tree.map(np.asarray, jsys.loop), "cpu")
    carried = types.SimpleNamespace(
        est=loop.est, mats=loop.mats,
        layers=interop.layers_from_numpy(
            jax.tree.map(np.asarray, jsys.layers), "cpu"),
        basis=types.SimpleNamespace(
            mask=torch.as_tensor(np.array(jsys.basis.mask)),
            stack=torch.as_tensor(np.array(jsys.basis.stack))),
        dm_model=types.SimpleNamespace(influence=loop.influence),
        var_model=var.VARModel(
            A=torch.as_tensor(np.array(jsys.var_model.A)), order=2))
    got = orr.oracle_params(cfg, carried)
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(w),
                                      err_msg=k)
    # (b) the port's own build
    got = orr.oracle_params(cfg, psys)
    var_fit = {"A1", "A2", "M1", "M2"}
    for k, w in want.items():
        g, w = np.asarray(got[k]), np.asarray(w)
        assert g.shape == w.shape and g.dtype == w.dtype, k
        scale = np.abs(w).max() if w.size else 0.0
        if k == "closed_form":
            # JAX forms -0.5 pinv(H'H) H' in float32, whose cutoff drops
            # most directions at R=32 (ROADMAP C, caveats); the fastmpc
            # oracle does not read it
            np.testing.assert_array_equal(g, P.host(psys.mats.closed_form))
        elif k in var_fit:
            np.testing.assert_allclose(g, w, rtol=0, atol=0.02 * scale,
                                       err_msg=k)
        elif g.dtype == bool or g.ndim == 0:
            np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-5 * scale,
                                       err_msg=k)
    # the port's free-response rows are its own VAR model's
    nx = got["A1"].shape[0]
    np.testing.assert_allclose(got["M1"][:nx], got["A1"], rtol=0,
                               atol=1e-6 * np.abs(got["A1"]).max())
    np.testing.assert_allclose(got["M2"][:nx], got["A2"], rtol=0,
                               atol=1e-6 * np.abs(got["A2"]).max())


def test_oracle_copy_equals_the_tests_oracle(oracle_builds):
    cfg, _, _, psys = oracle_builds
    params = orr.oracle_params(cfg, psys)
    noise = 0.03 * np.random.default_rng(4).standard_normal(
        (5, psys.est.n_pixels))
    for gn in (0, 1):
        got = _oracle_numpy.closed_loop(params, 5, noise,
                                        gauss_newton_iters=gn)
        want = oracle_numpy.closed_loop(params, 5, noise,
                                        gauss_newton_iters=gn)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def test_oracle_rows_equal_the_jax_scripts(monkeypatch, tmp_path):
    for k, v in ORACLE_SMALL.items():
        monkeypatch.setenv(k, v)
    jout = tmp_path / "jax.json"
    mod = _jax_script("oracle_reference_rows")
    monkeypatch.setattr("sys.argv", ["oracle", str(jout)])
    mod.main()
    want = json.loads(jout.read_text())
    pout = tmp_path / "port.json"
    got = orr.main([str(pout)], dict(ORACLE_SMALL, ORACLE_DEVICE="cpu"))
    assert json.loads(pout.read_text()) == json.loads(json.dumps(got))
    assert set(got) == set(want) | {"device"}
    assert set(got["rows"]) == set(want["rows"]) == {
        f"d_over_r0={d}_gn={gn}" for d in (5, 10) for gn in (0, 1)}
    for key, row in want["rows"].items():
        assert set(got["rows"][key]) == set(row)
        for k, w in row.items():
            if k == "oracle_s":
                continue
            if isinstance(w, bool):
                assert got["rows"][key][k] == w, (key, k)
            else:
                assert got["rows"][key][k] == pytest.approx(w, rel=2e-3,
                                                            abs=2e-4), (key, k)
