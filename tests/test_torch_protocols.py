"""The port's experiment protocols (mpc_sensorlessao_tpu_torch/benchmarks/:
protocol_sweep, protocol_edge, excursion_tail, modes_horizon,
montecarlo_sweep, full_protocol and their helpers in _protocol.py) against
the repository's JAX scripts (benchmarks/*.py), on the CPU.

* Configurations: each JAX script's SystemConfigs, captured by replacing
  the JAX ``pipeline.build`` in-process with one that records its config
  and stops the script, equal the port's (``dataclasses.asdict``).
* Row helpers: the port's settled, tail and modes rows, Monte-Carlo
  cells (divergence rule included, read from the JAX script's own report
  over the same arrays) and VAR validation equal the JAX scripts' on the
  same arrays.
* Rows: one reference row (the D/r0 grid as a scenario axis) and one
  tuned row at R=64, each from the package's own build, with injected
  noise, against the JAX build and simulate, at the golden trajectory
  tolerances (residual RMS rtol 0.01 / atol 5e-3).
* Entry points: each ``main(argv, env)`` on "cpu" at R=32 gives the JAX
  script's report keys (its record file's), writes only the path it is
  given, and a staged or resumed second run merges into that file.
"""

import dataclasses
import json
import sys
import types
from collections import namedtuple
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mpc_sensorlessao_tpu.models.closed_loop as jcl
import mpc_sensorlessao_tpu.models.pipeline as jpipeline
from mpc_sensorlessao_tpu.models import var as jvar
from mpc_sensorlessao_tpu.utils import config as jconfig
from mpc_sensorlessao_tpu_torch import reference_config
from mpc_sensorlessao_tpu_torch.benchmarks import _protocol as P
from mpc_sensorlessao_tpu_torch.benchmarks import excursion_tail as xt
from mpc_sensorlessao_tpu_torch.benchmarks import full_protocol as fp
from mpc_sensorlessao_tpu_torch.benchmarks import latency_b1 as lb
from mpc_sensorlessao_tpu_torch.benchmarks import modes_horizon as mh
from mpc_sensorlessao_tpu_torch.benchmarks import montecarlo_100k
from mpc_sensorlessao_tpu_torch.benchmarks import montecarlo_sweep as mcs
from mpc_sensorlessao_tpu_torch.benchmarks import protocol_edge as pe
from mpc_sensorlessao_tpu_torch.benchmarks import protocol_sweep as ps
from mpc_sensorlessao_tpu_torch.models import closed_loop, pipeline, var
from mpc_sensorlessao_tpu_torch.utils.config import mag_conv
from torch_script_support import _captured_cfg, _jax_script, _same

torch.backends.cuda.matmul.allow_tf32 = False
# one intra-op thread a worker: the suite runs one file per worker
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
Out = namedtuple("Out", "rms_res rms_turb strehl_exact strehl")


# ------------------------------------------------------- configurations

def _prior_rows(path, res, steps):
    """An excursion report holding the order-10 arm, so that the JAX
    script's resume builds the order-14 arm first."""
    path.write_text(json.dumps({"resolution": res, "n_steps": steps,
                                "rows": {"d=15_order10": {}}}))
    return str(path)


CONFIG_CASES = {
    # case: (JAX script, argv ("{out}": a path under tmp_path), env, the
    # port's config)
    "sweep_ref": ("protocol_sweep", ["512", "{out}"], {"PROTO_STAGES": "ref"},
                  lambda: ps.base_cfg(512, {})),
    "sweep_ref_cut": ("protocol_sweep", ["512", "{out}"], {
        "PROTO_STAGES": "ref", "PROTO_TRAIN": "1000", "PROTO_STEPS": "50"},
        lambda: ps.base_cfg(512, {"PROTO_TRAIN": "1000",
                                  "PROTO_STEPS": "50"})),
    "sweep_tuned_5": ("protocol_sweep", ["512", "{out}"], {
        "PROTO_STAGES": "tuned", "PROTO_TUNED_DR0": "5",
        "PROTO_TRAIN": "1000"},
        lambda: P.tuned_cfg(ps.base_cfg(512, {"PROTO_TRAIN": "1000"}), 5.0)),
    "sweep_tuned_20": ("protocol_sweep", ["128", "{out}"], {
        "PROTO_STAGES": "tuned", "PROTO_DR0": "20"},
        lambda: P.tuned_cfg(ps.base_cfg(128, {}), 20.0)),
    "montecarlo_10": ("montecarlo_sweep", ["512", "{out}"], {
        "MC_DR0": "10", "MC_STEPS": "500"},
        lambda: mcs.sweep_cfg(512, 10.0, 500)),
    "montecarlo_15": ("montecarlo_sweep", ["128", "{out}"], {"MC_DR0": "15"},
                      lambda: mcs.sweep_cfg(128, 15.0, 500)),
    "modes_6": ("modes_horizon", ["{out}"], {"MODES_ORDERS": "6"},
                lambda: mh.order_cfg(mh.base_cfg(128, 200), 6)),
    "modes_14_cut": ("modes_horizon", ["{out}"], {
        "MODES_ORDERS": "14", "MODES_RES": "64", "MODES_STEPS": "20",
        "MODES_TRAIN": "300"},
        lambda: mh.order_cfg(mh.base_cfg(64, 20, 300), 14)),
    "edge_ref": ("protocol_edge", ["512", "{out}"], {
        "PE_STAGES": "ref", "PE_TRAIN": "1000"},
        lambda: pe.sim_cfg(512, None, 1000, "conditional")),
    "edge_periodic": ("protocol_edge", ["512", "{out}"], {
        "PE_STAGES": "periodic", "PE_TRAIN": "2000", "PE_STEPS": "100"},
        lambda: pe.sim_cfg(512, 100, 2000, "periodic")),
    "edge_tuned_10": ("protocol_edge", ["512", "{out}"], {
        "PE_STAGES": "tuned", "PE_TUNED_DR0": "10", "PE_TRAIN": "1000"},
        lambda: P.tuned_cfg(pe.sim_cfg(512, None, 1000, "conditional"),
                            10.0)),
    "excursion_order10": ("excursion_tail", ["512", "{out}"], {
        "XT_DR0": "15", "XT_TRAIN": "1000"},
        lambda: P.tuned_cfg(xt.base_cfg(512, {"XT_TRAIN": "1000"}), 15.0)),
    "full_protocol": ("full_protocol", ["128", "32"], {},
                      lambda: reference_config(resolution=128)),
    "latency": ("latency_b1", ["{out}"], {"LAT_RES": "128", "BENCH_GN": "1"},
                lambda: lb.latency_cfg(128, 1)),
}


@pytest.mark.parametrize("case", sorted(CONFIG_CASES))
def test_configs_equal_the_jax_scripts(case, monkeypatch, tmp_path):
    """Each JAX script's config (first pipeline.build of the run) equals
    the port's, field by field."""
    name, argv, env, port = CONFIG_CASES[case]
    argv = [a.format(out=tmp_path / "out.json") for a in argv]
    _same(_captured_cfg(monkeypatch, name, argv, env), port())


def test_excursion_order14_arm_equals_the_jax_arm(monkeypatch, tmp_path):
    """The JAX script resumed after its order-10 arm builds the order-14
    clamp arm: the port's arm (order 14, var_max_radius 0.85)."""
    out = _prior_rows(tmp_path / "tail.json", 512, 500)
    jcfg = _captured_cfg(monkeypatch, "excursion_tail", ["512", out],
                         {"XT_DR0": "15", "XT_TRAIN": "1000"})
    _same(jcfg, P.tuned_cfg(xt.base_cfg(512, {"XT_TRAIN": "1000"}), 15.0,
                            *xt.ARMS[1][1:]))
    assert jcfg.mpc.var_max_radius == 0.85 and jcfg.zernike.radial_order == 14


def test_excursion_order10_arm_is_the_sweeps_tuned_row():
    """At the records' split (XT_TRAIN=1000, PROTO_TRAIN=1000: n_valid
    50 both) the order-10 excursion arm is protocol_sweep's tuned D/r0=15
    build, so one run serves both records."""
    arm = P.tuned_cfg(xt.base_cfg(512, {"XT_TRAIN": "1000"}), 15.0,
                      *xt.ARMS[0][1:])
    tuned = P.tuned_cfg(ps.base_cfg(512, {"PROTO_TRAIN": "1000"}), 15.0)
    assert dataclasses.asdict(arm) == dataclasses.asdict(tuned)
    assert arm.sim.n_valid == 50


def test_population_and_modes_share_the_tuned_recipe():
    """montecarlo_100k.tuned_cfg and the modes recipe at D/r0=5 are the
    one tuned recipe of _protocol (the modes sweep's prior scale 0.1 is
    min(0.15, 0.5/5))."""
    cfg = montecarlo_100k.tuned_cfg(64, 10.0, 7)
    assert (cfg.sim.n_train, cfg.sim.n_valid, cfg.sim.n_test) == (300, 50, 7)
    assert cfg.estimator.prior_scale == 0.05
    assert mh.order_cfg(mh.base_cfg(128, 200), 10).estimator.prior_scale \
        == 0.1


# ---------------------------------------------------------- row helpers

def _arrays(B=4, T=12, seed=3):
    """Telemetry arrays (B, T): a locked scenario, a collapsed one (the
    crop flag), one with Strehl runs under 0.5, and one diverged past
    10x its turbulence."""
    rng = np.random.default_rng(seed)
    turb = (0.6 + 0.05 * rng.random((B, T))).astype(np.float32)
    res = (0.15 + 0.02 * rng.random((B, T))).astype(np.float32)
    res[1] = 1.2 * turb[1]
    res[3, T // 2:] = 11.0 * turb[3, T // 2:]
    sx = np.exp(-res ** 2).astype(np.float32)
    sx[2, [6, 7, 9]] = [0.3, 0.45, 0.2]
    sm = np.exp(-1.1 * res ** 2).astype(np.float32)
    return res, turb, sx, sm


def _outs(res, turb, sx, sm):
    return (Out(res, turb, sx, sm),
            Out(*(torch.as_tensor(a) for a in (res, turb, sx, sm))))


@pytest.mark.parametrize("script", ["protocol_sweep", "protocol_edge"])
def test_settled_row_equals_the_jax_scripts(script):
    mod = _jax_script(script)
    jout, out = _outs(*_arrays())
    for i in range(4):
        assert P.settled_row(out, i) == mod._settled_row(jout, i), i
    one = Out(*(a[1] for a in jout))
    assert P.settled_row(Out(*(a[1] for a in out))) == mod._settled_row(one)
    assert P.settled_row(out, 1)["strehl_exact_crop_valid"] is False


def test_tail_row_equals_the_jax_scripts():
    mod = _jax_script("excursion_tail")
    jout, out = _outs(*_arrays())
    for i in range(4):
        got = P.tail_row(Out(*(a[i] for a in out)))
        assert got == mod._row(Out(*(a[i] for a in jout))), i
    got = P.tail_row(Out(*(a[2] for a in out)))
    assert got["longest_excursion_steps"] == 2
    assert got["frac_steps_strehl_below_0.5"] == 0.5


def test_modes_row_equals_the_jax_scripts():
    mod = _jax_script("modes_horizon")
    jout, out = _outs(*_arrays())
    assert P.modes_row(out, 0.37, 4, 12) == mod._row(jout, 0.37, 4, 12)


def test_mc_cells_equal_the_jax_scripts_report(monkeypatch, tmp_path):
    """The JAX montecarlo_sweep main, its build and simulate replaced by
    stand-ins that hand each scenario (picked by its PRNG key) rows of
    fixed arrays, writes cells that P.mc_cells reproduces exactly on the
    same arrays -- including a NaN scenario and one over 10x its
    turbulence, both counted diverged and kept out of the means."""
    mod = _jax_script("montecarlo_sweep")
    snrs, reps, T, d = (10.0, 20.0), 3, 12, 5.0
    rng = np.random.default_rng(8)
    n = len(snrs) * reps
    turb = (0.6 + 0.05 * rng.random((n, T))).astype(np.float32)
    res = (0.15 + 0.05 * rng.random((n, T))).astype(np.float32)
    res[1, 8] = np.nan
    res[4] = 12.0 * turb[4]
    sx = np.exp(-res ** 2).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(int(d)), n)

    def simulate(loop, layers, cfg, key, n_steps, start_step, noise_scale,
                 init_u):
        i = jnp.argmax(jnp.all(keys == key, axis=-1))
        return Out(jnp.asarray(res)[i], jnp.asarray(turb)[i],
                   jnp.asarray(sx)[i], jnp.asarray(sx)[i])
    monkeypatch.setattr(jpipeline, "build",
                        lambda cfg, key: types.SimpleNamespace(
                            loop=None, layers=None))
    monkeypatch.setattr(jpipeline, "warm_start_command",
                        lambda *a: jnp.zeros(1))
    monkeypatch.setattr(jcl, "simulate", simulate)
    path = tmp_path / "mc.json"
    monkeypatch.setattr(sys, "argv", ["mc", "32", str(path)])
    for k, v in {"MC_DR0": "5", "MC_SNR": "10,20", "MC_REPS": str(reps),
                 "MC_STEPS": str(T)}.items():
        monkeypatch.setenv(k, v)
    mod.main()
    want = json.loads(path.read_text())["cells"]
    got = P.mc_cells(Out(*(torch.as_tensor(a) for a in (res, turb, sx, sx))),
                     d, snrs, reps)
    assert got == want
    assert want["d=5,snr=10dB"]["n_diverged"] == 1
    assert want["d=5,snr=20dB"]["n_diverged"] == 1


def test_var_validation_matches_the_jax_scripts():
    """P.var_validation (the float64 VAR model over the float32 series)
    against the JAX script's _var_validation (float32): equal to one unit
    of the fifth digit they round to."""
    mod = _jax_script("protocol_sweep")
    rng = np.random.default_rng(2)
    T, n = 120, 5
    x = np.zeros((T, n + 1), np.float32)
    for t in range(2, T):
        x[t, 1:] = (0.7 * x[t - 1, 1:] - 0.2 * x[t - 2, 1:]
                    + rng.normal(size=n))
    cfg = jconfig.reference_config(resolution=32)
    cfg = cfg.replace(sim=dataclasses.replace(cfg.sim, n_train=80,
                                              n_valid=40))
    jsys = types.SimpleNamespace(
        coeff_series=jnp.asarray(x),
        var_model=jvar.fit(jnp.asarray(x[:80, 1:]), 2))
    psys = types.SimpleNamespace(
        coeff_series=torch.as_tensor(x),
        var_model=var.fit(torch.as_tensor(x[:80, 1:]).double(), 2))
    want = mod._var_validation(cfg, jsys)
    got = P.var_validation(cfg, psys)
    assert got.keys() == want.keys()
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-5, k
    raw = P.var_validation(cfg, psys, digits=None)
    assert abs(raw["var_rmse_mean"] - got["var_rmse_mean"]) <= 5e-6


# ------------------------------------------------------------------ rows

def _cut(cfg, steps):
    return cfg.replace(sim=dataclasses.replace(cfg.sim, n_train=300,
                                               n_valid=50, n_test=steps))


def _jax_tuned(d, steps):
    cfg = _cut(jconfig.reference_config(resolution=64), steps)
    return cfg.replace(
        zernike=dataclasses.replace(cfg.zernike, radial_order=10),
        mpc=dataclasses.replace(cfg.mpc, warm_start=True, var_ridge=1e-2,
                                r_weight=30.0),
        estimator=dataclasses.replace(cfg.estimator, method="mmse",
                                      prior_scale=min(0.15, 0.5 / d)),
        sim=dataclasses.replace(cfg.sim, d_over_r0=d))


def _row_pair(jcfg, cfg, mags, warm, seed):
    """The JAX and the port's own build of the same config, one loop each
    over the scenarios ``mags`` on the shared test window with the same
    injected noise (and each build's own warm start).  Returns both
    outputs."""
    steps = cfg.sim.n_test
    start = cfg.sim.n_train + cfg.sim.n_valid
    jsys = jpipeline.build(jcfg, jax.random.PRNGKey(0))
    sys_ = pipeline.build(cfg, "cpu")
    noise = (float(sys_.est.noise_std) * np.random.default_rng(seed)
             .standard_normal((len(mags), steps, sys_.est.n_pixels))
             ).astype(np.float32)
    j_init = (jpipeline.warm_start_command(jsys, jcfg, start) if warm
              else None)
    ref = jax.vmap(lambda m, nz: jcl.simulate(
        jsys.loop, jsys.layers, jcfg, jax.random.PRNGKey(1),
        n_steps=steps, start_step=float(start), mag=m, noise_seq=nz,
        init_u=j_init))(jnp.asarray(mags, jnp.float32), jnp.asarray(noise))
    out = closed_loop.simulate(
        sys_.loop, sys_.layers, cfg, None, n_steps=steps, start_step=start,
        mag=torch.tensor(mags), noise_seq=torch.as_tensor(noise),
        init_u=(pipeline.warm_start_command(sys_, cfg, start) if warm
                else None))
    return ref, out


def _hold_rows(ref, out, n):
    jrows = [P.settled_row(Out(*(np.asarray(getattr(ref, f))[i]
                                 for f in Out._fields))) for i in range(n)]
    rows = [P.settled_row(out, i) for i in range(n)]
    np.testing.assert_allclose(out.rms_res.numpy(), np.asarray(ref.rms_res),
                               rtol=0.01, atol=5e-3)
    for row, jrow in zip(rows, jrows):
        assert row["finite"] and jrow["finite"]
        np.testing.assert_allclose(row["mean_rms_res_rad"],
                                   jrow["mean_rms_res_rad"], rtol=0.01,
                                   atol=5e-3)
        np.testing.assert_allclose(row["mean_strehl"], jrow["mean_strehl"],
                                   atol=5e-3)
    return rows


def test_reference_row_matches_jax_simulate():
    """protocol_sweep's reference configuration at R=64 (300/50 split, 10
    steps), D/r0 5 and 10 as a scenario axis on one build, cold start."""
    jcfg = _cut(jconfig.reference_config(resolution=64), 10)
    cfg = ps.base_cfg(64, {"PROTO_TRAIN": "300", "PROTO_STEPS": "10"})
    _same(jcfg, cfg)
    mags = [mag_conv(5.0), mag_conv(10.0)]
    ref, out = _row_pair(jcfg, cfg, mags, warm=False, seed=11)
    rows = _hold_rows(ref, out, 2)
    assert rows[0]["rejection"] > 1.2


def test_tuned_row_matches_jax_simulate():
    """protocol_sweep's tuned build at R=64, D/r0=10 (300/50 split, 10
    steps), from each build's own warm start."""
    jcfg = _jax_tuned(10.0, 10)
    cfg = P.tuned_cfg(ps.base_cfg(64, {"PROTO_TRAIN": "300",
                                       "PROTO_STEPS": "10"}), 10.0)
    _same(jcfg, cfg)
    ref, out = _row_pair(jcfg, cfg, [mag_conv(10.0)], warm=True, seed=12)
    _hold_rows(ref, out, 1)


# ---------------------------------------------------------- entry points

# keys written into the records by hand, not by the scripts
HAND_WRITTEN = {"notes", "conclusion"}


def _record_keys(name):
    rec = json.loads((ROOT / name).read_text())
    return {k: v for k, v in rec.items() if k not in HAND_WRITTEN}


@pytest.fixture
def quiet_dir(tmp_path, monkeypatch):
    """An empty working directory: an entry point must write nothing into
    it."""
    cwd = tmp_path / "cwd"
    cwd.mkdir()
    monkeypatch.chdir(cwd)
    yield tmp_path
    assert not any(cwd.iterdir()), list(cwd.iterdir())


def _only(tmp_path, *names):
    assert sorted(p.name for p in tmp_path.iterdir()) == sorted(
        ["cwd", *names])


SWEEP_ENV = {"PROTO_DEVICE": "cpu", "PROTO_TRAIN": "300", "PROTO_STEPS": "4",
             "PROTO_DR0": "5,10"}


def test_protocol_sweep_main_keys_and_staged_merge(quiet_dir):
    """Stage ref, then stage tuned into the same file: the merged report
    has RESULTS_r05.json's keys, its rows the record's row keys."""
    out = str(quiet_dir / "r.json")
    ps.main(["32", out], dict(SWEEP_ENV, PROTO_STAGES="ref"))
    first = json.loads(Path(out).read_text())
    assert first["tuned_rows"] == {} and len(first["reference_rows"]) == 2
    rep = ps.main(["32", out], dict(SWEEP_ENV, PROTO_STAGES="tuned",
                                    PROTO_TUNED_DR0="5"))
    rec = _record_keys("RESULTS_r05.json")
    saved = json.loads(Path(out).read_text())
    assert saved == json.loads(json.dumps(rep))
    assert set(saved) == set(rec)
    assert saved["reference_rows"] == first["reference_rows"]
    assert saved["device"] == "cpu" and saved["n_valid"] == 50
    row_keys = set(rec["reference_rows"]["d_over_r0=5"])
    for row in saved["reference_rows"].values():
        assert set(row) - {"strehl_exact_crop_valid"} == row_keys
    assert set(saved["tuned_rows"]["d_over_r0=5"]) == set(
        rec["tuned_rows"]["d_over_r0=5"])
    _only(quiet_dir, "r.json")


def test_protocol_edge_main_keys_and_staged_merge(quiet_dir):
    out = str(quiet_dir / "e.json")
    env = {"PE_DEVICE": "cpu", "PE_TRAIN": "300", "PE_STEPS": "4",
           "PE_DR0": "5,10", "PE_MC_B": "2", "PE_TUNED_DR0": "5"}
    pe.main(["32", out], dict(env, PE_STAGES="ref,mc"))
    pe.main(["32", out], dict(env, PE_STAGES="periodic,tuned"))
    saved = json.loads(Path(out).read_text())
    rec = _record_keys("RESULTS_EDGE_r05.json")
    assert set(saved) == set(rec)
    assert set(saved["monte_carlo"]) == set(rec["monte_carlo"])
    assert set(saved["quality_delta_strehl"]) == {"d_over_r0=5",
                                                  "d_over_r0=10"}
    assert set(saved["tuned_rows"]["d_over_r0=5"]) == set(
        rec["tuned_rows"]["d_over_r0=5"])
    assert (saved["n_train"], saved["n_valid"]) == (300, 50)
    _only(quiet_dir, "e.json")


def test_excursion_tail_main_keys_and_resume(quiet_dir, monkeypatch):
    """The second run finds both arms in the file and builds nothing."""
    out = str(quiet_dir / "t.json")
    env = {"XT_DEVICE": "cpu", "XT_TRAIN": "300", "XT_STEPS": "4",
           "XT_DR0": "15"}
    first = xt.main(["32", out], env)
    rec = _record_keys("RESULTS_TAIL_r05.json")
    assert set(first["rows"]["d=15_order14_clamp"]) == set(
        rec["rows"]["d=15_order14_clamp"])
    assert set(first["d=15_tail_verdict"]) == set(rec["d=15_tail_verdict"])
    assert set(first) == {k for k in rec if not k.startswith("d=20")}

    def no_build(*a, **k):
        raise AssertionError("resumed run built a system")
    monkeypatch.setattr(pipeline, "build", no_build)
    again = xt.main(["32", out], env)
    assert again["rows"] == json.loads(json.dumps(first["rows"]))
    _only(quiet_dir, "t.json")


def test_modes_and_montecarlo_main_keys(quiet_dir):
    out_m, out_c = str(quiet_dir / "m.json"), str(quiet_dir / "c.json")
    rep = mh.main([out_m], {"MODES_DEVICE": "cpu", "MODES_RES": "32",
                            "MODES_BATCH": "2", "MODES_STEPS": "4",
                            "MODES_ORDERS": "6", "MODES_HORIZONS": "2,16",
                            "MODES_TRAIN": "300"})
    rec = _record_keys("MODES_r04.json")
    assert set(rep) == set(rec)
    assert set(rep["cells"]) == {"order=6_N=2_fixed", "order=6_N=16_fixed",
                                 "order=6_N=16_general_cr"}
    for cell in rep["cells"].values():
        assert set(cell) == set(rec["cells"]["order=6_N=2_fixed"])
    rep = mcs.main(["32", out_c], {"MC_DEVICE": "cpu", "MC_DR0": "5",
                                   "MC_SNR": "10", "MC_REPS": "2",
                                   "MC_STEPS": "4"})
    rec = _record_keys("MONTECARLO512_r05.json")
    assert set(rep) == set(rec)
    assert set(rep["cells"]["d=5,snr=10dB"]) == set(
        rec["cells"]["d=5,snr=10dB"])
    assert rep["cells"]["d=5,snr=10dB"]["n_diverged"] == 0
    assert json.loads(Path(out_c).read_text()) == json.loads(json.dumps(rep))
    _only(quiet_dir, "m.json", "c.json")


def test_full_protocol_main_keys(quiet_dir):
    """The JAX script's keys (its report literal and the summary's) plus
    the device; nothing written."""
    rep = fp.main(["32", "2"], {"FP_DEVICE": "cpu"})
    summary = {"mean_rms_res", "p95_rms_res", "mean_rms_turb", "rejection",
               "mean_strehl", "min_strehl", "mean_strehl_exact",
               "min_strehl_exact", "mean_cost", "max_abs_u", "max_abs_du",
               "max_abs_volts"}
    assert set(rep) == {"resolution", "batch", "n_steps", "build_s",
                        "loop_s", "solves_per_s", "var_rmse_mean",
                        "var_rrmse_mean", "health", "device"} | summary
    assert rep["n_steps"] == 500 and rep["health"] == "OK"
    _only(quiet_dir)
