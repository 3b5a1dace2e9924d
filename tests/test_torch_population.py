"""The port's checkpointed Monte-Carlo population
(benchmarks/montecarlo_100k.py), its utilities (utils/checkpoint.py,
utils/guards.py) and the multi-rank dry run (parallel/dryrun.py), on the
CPU at R=32.

* Kill and resume: the population stopped after one chunk
  (MC1_STOP_AFTER) and resumed from its checkpoint gives summaries
  bit-identical to an uninterrupted run (the JAX package's
  tests/test_montecarlo_resume.py, in-process and not slow here).
* One chunk against the JAX script's chunk (vmap of simulate over the
  scenarios, settled means of exact Strehl, residual and turbulence
  RMS) on the carried JAX tuned build with injected noise, to
  tests/test_torch_loop.py's _assert_trajectory tolerance.
* guards.check_outputs gives the JAX one's verdict and messages on the
  same telemetry; checkpoint round-trips trees and overwrites
  atomically.
* dryrun_multichip over four gloo ranks.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_sensorlessao_tpu.models import closed_loop as jcl
from mpc_sensorlessao_tpu.models import pipeline as jpipeline
from mpc_sensorlessao_tpu.utils import config as jconfig
from mpc_sensorlessao_tpu.utils import guards as jguards
from mpc_sensorlessao_tpu_torch import interop
from mpc_sensorlessao_tpu_torch.benchmarks import montecarlo_100k as mc
from mpc_sensorlessao_tpu_torch.models import closed_loop, pipeline
from mpc_sensorlessao_tpu_torch.parallel import dryrun, montecarlo
from mpc_sensorlessao_tpu_torch.utils import checkpoint, guards
from mpc_sensorlessao_tpu_torch.utils.config import mag_conv

import torch_parallel_support as support

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False

ENV = {"MC1_DEVICE": "cpu", "MC1_DR0": "5", "MC1_SNR": "10,20",
       "MC1_REPS": "4", "MC1_CHUNK": "2", "MC1_STEPS": "5"}


def test_population_resumes_bit_identically(tmp_path):
    """Uninterrupted (A); stopped after 1 of 2 chunks, then resumed (B):
    the summaries, the checkpoints and the cells agree exactly."""
    ck_a, ck_b = str(tmp_path / "ck_a"), str(tmp_path / "ck_b")
    out_a, out_b = str(tmp_path / "a.json"), str(tmp_path / "b.json")
    rep_a = mc.main(["32", out_a], dict(ENV, MC1_CKPT=ck_a))
    with pytest.raises(SystemExit) as stop:
        mc.main(["32", out_b], dict(ENV, MC1_CKPT=ck_b, MC1_STOP_AFTER="1"))
    assert stop.value.code == mc.STOPPED
    assert not os.path.exists(out_b)          # stopped before the report
    mid = checkpoint.restore(ck_b)
    assert int(mid["cursor"]) == 1
    assert np.isnan(mid["summaries"][0, 1]).all()
    rep_b = mc.main(["32", out_b, "--resume"], dict(ENV, MC1_CKPT=ck_b))
    assert rep_b["resumed_at_cursor"] == 1
    assert rep_b["per_d"]["d=5"]["chunks_run"] == 1
    np.testing.assert_array_equal(rep_a["summaries"], rep_b["summaries"])
    assert np.isfinite(rep_a["summaries"]).all()
    with open(out_a) as fa, open(out_b) as fb:
        assert json.load(fa)["cells"] == json.load(fb)["cells"]
    st_a, st_b = checkpoint.restore(ck_a), checkpoint.restore(ck_b)
    np.testing.assert_array_equal(st_a["summaries"], st_b["summaries"])
    assert int(st_a["cursor"]) == int(st_b["cursor"]) == 2
    for cell in rep_a["cells"].values():
        assert cell["n"] == 4 and cell["n_diverged"] == 0


def test_population_chunk_seeds_depend_on_the_chunk_only():
    seeds = [mc.chunk_seed(c) for c in range(4)]
    assert len(set(seeds)) == 4
    assert seeds == [mc.chunk_seed(c) for c in range(4)]
    assert all(0 <= s < 2 ** 63 for s in seeds)


def _jax_tuned_cfg(d, n_steps):
    cfg = jconfig.reference_config(resolution=32)
    return cfg.replace(
        zernike=dataclasses.replace(cfg.zernike, radial_order=10),
        mpc=dataclasses.replace(cfg.mpc, warm_start=True, var_ridge=1e-2,
                                r_weight=30.0),
        estimator=dataclasses.replace(cfg.estimator, method="mmse",
                                      prior_scale=min(0.15, 0.5 / d)),
        sim=dataclasses.replace(cfg.sim, d_over_r0=d, n_train=300,
                                n_valid=50, n_test=n_steps))


def test_population_chunk_matches_jax_script_chunk():
    """One chunk (2 SNRs x 2 reps, 10 steps, D/r0=5) through run_chunk on
    the carried JAX tuned build against the JAX script's run_chunk body
    on the same injected noise."""
    d, n_steps, reps, snrs = 5.0, 10, 2, (10.0, 20.0)
    jcfg = _jax_tuned_cfg(d, n_steps)
    cfg = mc.tuned_cfg(32, d, n_steps)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    jsys = jpipeline.build(jcfg, jax.random.PRNGKey(0))
    start = jcfg.sim.n_train + jcfg.sim.n_valid
    j_init = jpipeline.warm_start_command(jsys, jcfg, start)
    scales = np.repeat([10.0 ** ((jcfg.estimator.snr_db - s) / 20.0)
                        for s in snrs], reps).astype(np.float32)
    B, p = len(scales), int(jsys.loop.est.b_s.shape[0])
    noise = (float(jsys.loop.est.noise_std) * np.random.default_rng(5)
             .standard_normal((B, n_steps, p))).astype(np.float32)
    settle = n_steps // 2

    def one(nseq, ns):
        out = jcl.simulate(jsys.loop, jsys.layers, jcfg,
                           jax.random.PRNGKey(1), n_steps=n_steps,
                           start_step=float(start), mag=mag_conv(d),
                           noise_scale=ns, init_u=j_init, noise_seq=nseq)
        return (jnp.mean(out.strehl_exact[settle:]),
                jnp.mean(out.rms_res[settle:]),
                jnp.mean(out.rms_turb[settle:]))
    ref = np.stack([np.asarray(a) for a in jax.vmap(one)(
        jnp.asarray(noise), jnp.asarray(scales))])

    system = pipeline.System(
        basis=None, layers=interop.layers_from_numpy(
            jax.tree.map(np.asarray, jsys.layers), "cpu"),
        est=None, dm_model=None, var_model=None, mats=None,
        loop=interop.loop_models_from_numpy(
            jax.tree.map(np.asarray, jsys.loop), "cpu"),
        coeff_series=None)
    got = mc.run_chunk(system, cfg, float(start), mag_conv(d),
                       torch.as_tensor(scales), torch.as_tensor(
                           np.array(j_init)), n_steps,
                       noise_seq=torch.as_tensor(noise))
    assert got.shape == (3, B)
    np.testing.assert_allclose(got, ref, rtol=0.01, atol=5e-3)


def _telemetry(**bad):
    """Single-scenario-batch telemetry (B=2, T=6, nu=3) as numpy, with
    entries of ``bad`` put in."""
    rng = np.random.default_rng(3)
    T, nu = 6, 3
    t = dict(u=0.1 * rng.standard_normal((2, T, nu)),
             x_est=rng.standard_normal((2, T, 4)),
             cost=rng.random((2, T)), volts=rng.random((2, T, nu)),
             rms_res=0.2 + 0.01 * rng.random((2, T)),
             rms_turb=np.full((2, T), 0.7))
    t["du"] = np.diff(t["u"], axis=1, prepend=0.0)
    for k, v in bad.items():
        t[k] = v(t[k].copy())
    return {k: v.astype(np.float32) for k, v in t.items()}


def _nan_at(a):
    a[0, 2] = np.nan
    return a


GUARD_CASES = {
    "healthy": ({}, {}),
    "nan_u": ({"u": _nan_at}, {}),
    "nan_rms": ({"rms_res": _nan_at, "cost": _nan_at}, {}),
    "box": ({"u": lambda a: a + 2.0}, {"u_max": 1.0}),
    "ramp": ({"du": lambda a: a + 0.5}, {"du_max": 0.1}),
    "diverged": ({"rms_res": lambda a: a * 30.0}, {}),
}


@pytest.mark.parametrize("case", sorted(GUARD_CASES))
def test_guards_match_jax(case):
    """Same verdict and issue messages as the JAX check_outputs on the
    same telemetry (numpy for JAX, torch tensors for the port)."""
    bad, kw = GUARD_CASES[case]
    tel = _telemetry(**bad)
    want = jguards.check_outputs(
        closed_loop.StepOutputs(**{f: tel.get(f, np.zeros(1)) for f in
                                   closed_loop.StepOutputs._fields}), **kw)
    got = guards.check_outputs(closed_loop.StepOutputs(**{
        f: torch.as_tensor(tel.get(f, np.zeros(1)))
        for f in closed_loop.StepOutputs._fields}), **kw)
    assert got.ok == want.ok == (case == "healthy")
    assert got.issues == want.issues
    assert str(got) == str(want)


def test_checkpoint_round_trips_a_system(tmp_path):
    """A built system's loop operators, screens and config, a scenario
    batch, numpy arrays and numbers come back equal, on the device asked
    for, and the config's JSON beside them."""
    cfg = dryrun.small_cfg()
    system = pipeline.build(cfg, "cpu")
    scen = montecarlo.make_scenarios(cfg, torch.Generator().manual_seed(1),
                                     4, device="cpu")
    tree = {"loop": system.loop, "layers": system.layers, "cfg": cfg,
            "scen": scen, "arr": np.arange(6.0).reshape(2, 3),
            "cursor": np.asarray(3, np.int64), "k": np.int64(5),
            "misc": [1, 2.5, "x", None, (True, 3)]}
    path = str(tmp_path / "ck")
    checkpoint.save(path, tree, config=cfg)
    back = checkpoint.restore(path, like=tree, device="cpu")
    assert back["cfg"] == cfg
    assert back["misc"] == tree["misc"]
    assert isinstance(back["arr"], np.ndarray)
    np.testing.assert_array_equal(back["arr"], tree["arr"])
    assert back["cursor"].shape == () and int(back["cursor"]) == 3
    assert back["k"] == 5 and isinstance(back["k"], np.int64)
    assert isinstance(back["scen"], montecarlo.ScenarioBatch)
    assert back["scen"].noise_seed == scen.noise_seed
    torch.testing.assert_close(back["scen"].mag, scen.mag, rtol=0, atol=0)
    for name, want in (("loop", system.loop), ("layers", system.layers)):
        got = back[name]
        assert type(got) is type(want)
        for f in dataclasses.fields(want):
            if not f.init:
                continue
            a, b = getattr(got, f.name), getattr(want, f.name)
            if isinstance(b, torch.Tensor):
                torch.testing.assert_close(a, b, rtol=0, atol=0)
    # the restored operators run the same loop
    out = [montecarlo.run_batch(t["loop"], t["layers"], cfg, scen, 3)
           for t in (tree, back)]
    torch.testing.assert_close(out[0].rms_res, out[1].rms_res, rtol=0,
                               atol=0)
    assert checkpoint.load_config_dict(path)["sim"]["n_train"] == 150


def test_checkpoint_overwrite_is_explicit_and_atomic(tmp_path):
    """save refuses an existing checkpoint without overwrite=True, and
    replaces it whole with it (no temporary file left behind); restore
    with a ``like`` of another structure raises."""
    path = str(tmp_path / "ck")
    checkpoint.save(path, {"a": np.zeros(3), "c": np.zeros((), np.int64)})
    with pytest.raises(FileExistsError):
        checkpoint.save(path, {"a": np.ones(3)})
    checkpoint.save(path, {"a": np.ones(3), "c": np.asarray(7, np.int64)},
                    overwrite=True)
    back = checkpoint.restore(path)
    np.testing.assert_array_equal(back["a"], np.ones(3))
    assert int(back["c"]) == 7
    assert sorted(os.listdir(path)) == [checkpoint.TREE_FILE]
    with pytest.raises(ValueError, match="structure"):
        checkpoint.restore(path, like={"a": np.ones(3)})
    with pytest.raises(ValueError, match="structure"):
        checkpoint.restore(path, like={"a": torch.ones(3),
                                       "c": np.zeros((), np.int64)})


def test_checkpoint_refuses_classes_outside_the_package(tmp_path):
    path = str(tmp_path / "ck")
    checkpoint.save(path, {"a": torch.zeros(2)})
    data = torch.load(os.path.join(path, checkpoint.TREE_FILE),
                      weights_only=True)
    data["spec"] = json.dumps({"namedtuple": "collections:OrderedDict",
                               "fields": {}})
    torch.save(data, os.path.join(path, checkpoint.TREE_FILE))
    with pytest.raises(ValueError, match="outside"):
        checkpoint.restore(path)


def test_dryrun_multichip_four_ranks():
    """dryrun_multichip(4) on four gloo CPU ranks: the DP runs over the
    periodic and the conditional flow, through the ramp solver and
    through cyclic reduction at horizon 16 count every scenario, the TP
    estimate and the horizon solve pass their checks on every rank."""
    with support.one_host_thread():
        ranks = dryrun.dryrun_multichip(4, device="cpu")
    assert len(ranks) == 4
    for r in ranks:
        assert r["dp"] == ranks[0]["dp"]
        assert r["dp"]["n_scenarios"] == 8 and r["dp"]["n_diverged"] == 0
        for run in ("dp_conditional", "dp_ramp", "dp_cyclic_reduction"):
            assert r[run]["n_scenarios"] == 8, run
            assert r[run] == ranks[0][run]
        assert r["tp_max_abs_err"] <= 1e-4
        assert r["hz_max_residual"] < 1e-3
