"""The port's step and flow timers and its scaling report
(mpc_sensorlessao_tpu_torch/benchmarks/step_breakdown.py,
step_knockouts.py, edge_flow_cost.py, edge_flow_breakdown.py,
scaling.py) against the repository's JAX scripts, on the CPU.

* Configurations: each JAX script's SystemConfig, captured by replacing
  the JAX ``pipeline.build`` in-process (tests/torch_script_support.py),
  equals the port's under the same argv and env.
* step_knockouts: the ``full`` variant's outputs equal
  closed_loop.simulate's on the same injected noise (the JAX script's own
  sanity row, made exact), ``stacked`` gives simulate's StepOutputs and
  ``packed`` them in one row; each main on "cpu" at R=32 reports the JAX
  script's keys.
* edge_flow_breakdown: its ``full_new`` step equals edge_flow.advance
  from the same state and noise, ``no_frac`` leaves the state advance
  leaves, ``"not_ported"`` names the four JAX rows with no counterpart;
  a staged run keeps the rows of the first.
* scaling: worlds of 1 and 2 gloo CPU ranks at R=32.
"""

import dataclasses
import json
import types

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import mpc_sensorlessao_tpu.models.pipeline as jpipeline
from mpc_sensorlessao_tpu_torch.benchmarks import edge_flow_breakdown as efb
from mpc_sensorlessao_tpu_torch.benchmarks import edge_flow_cost as efc
from mpc_sensorlessao_tpu_torch.benchmarks import scaling
from mpc_sensorlessao_tpu_torch.benchmarks import step_breakdown as sb
from mpc_sensorlessao_tpu_torch.benchmarks import step_knockouts as sk
from mpc_sensorlessao_tpu_torch.models import closed_loop, pipeline
from mpc_sensorlessao_tpu_torch.ops import edge_flow
from mpc_sensorlessao_tpu_torch.utils.config import reference_config
from torch_script_support import _captured_cfg, _jax_script, _same

torch.backends.cuda.matmul.allow_tf32 = False
# one intra-op thread a worker: the suite runs one file per worker
torch.set_num_threads(1)

START = 350.0
# the JAX step_knockouts.py variants (its :170-185) and step_breakdown.py
# keys (its :100-213)
KNOCKOUTS = ("full", "fused_noise", "no_exact", "no_rms", "no_noise", "lean",
             "stacked", "packed", "gn0", "gn1", "rms_reduction")
STAGES = ("turb_residual_us", "measure_us", "estimate_qp_us", "synthesis_us",
          "full_step_us", "sum_of_parts_us")


@pytest.fixture(autouse=True, scope="module")
def _one_blas_thread():
    """One BLAS thread a worker for numpy too: the suite runs one file per
    worker, and the float64 oracle's and the flow build's numpy solves
    oversubscribe the cores with BLAS's default threads."""
    with threadpool_limits(1):
        yield


def _skip_rows(mod):
    """Stub the JAX breakdown's timed rows, so that its main reaches the
    closed-loop build."""
    mod.breakdown_rows = lambda *a, **k: {}
    mod._measure_scan = lambda *a, **k: (0.0, (0.0, 0.0))


CONFIG_CASES = {
    # case: (JAX script, argv, env, prepare, the port's config)
    "breakdown_defaults": ("step_breakdown", [], {}, None,
                           lambda: sb.step_cfg(512, 25)),
    "breakdown_argv": ("step_breakdown", ["32", "4", "3"], {}, None,
                       lambda: sb.step_cfg(32, 3)),
    "knockouts_argv": ("step_knockouts", ["64", "8", "5", "full"], {}, None,
                       lambda: sb.step_cfg(64, 5)),
    "edge_cost_defaults": ("edge_flow_cost", [], {}, None,
                           lambda: efc.flow_cfg(128, 500, "periodic")),
    # the JAX script reads EFB_STEPS when imported: its default, 25
    "edge_breakdown": ("edge_flow_breakdown", ["{out}"], {
        "EFB_RES": "32", "EFB_CPU": "1"}, _skip_rows,
        lambda: efb.loop_cfg(32, 25, "periodic")),
    "scaling": ("scaling", ["8", "7"], {}, None,
                lambda: scaling.scaling_cfg(7)),
}


@pytest.mark.parametrize("case", sorted(CONFIG_CASES))
def test_configs_equal_the_jax_scripts(case, monkeypatch, tmp_path):
    name, argv, env, prepare, port = CONFIG_CASES[case]
    argv = [a.format(out=tmp_path / "out.json") for a in argv]
    _same(_captured_cfg(monkeypatch, name, argv, env, prepare), port())


def test_edge_flow_cost_configs_equal_the_jax_script(monkeypatch):
    """Both flows' builds (the JAX run recorded, its loops stubbed)."""
    mod = _jax_script("edge_flow_cost")
    cfgs = []

    def build(cfg, key):
        cfgs.append(cfg)
    zeros = np.zeros(6, np.float32)
    monkeypatch.setattr(jpipeline, "build", build)
    monkeypatch.setattr(jpipeline, "run_closed_loop",
                        lambda *a: types.SimpleNamespace(
                            rms_res=zeros, strehl_exact=zeros))
    monkeypatch.setattr("sys.argv", ["efc", "32", "6"])
    mod.main()
    assert len(cfgs) == len(efc.FLOWS)
    for jcfg, flow in zip(cfgs, efc.FLOWS):
        _same(jcfg, efc.flow_cfg(32, 6, flow))


@pytest.fixture(scope="module")
def small():
    cfg = sb.step_cfg(32, 6)
    return cfg, pipeline.build(cfg, "cpu")


def test_knockout_full_equals_simulate(small):
    """The full step (every flag on) is simulate's step: rtol 1e-5 on
    every output; the stacked layout is simulate's StepOutputs."""
    cfg, sys_ = small
    B, T = 3, 6
    rng = np.random.default_rng(5)
    seq = torch.as_tensor((float(sys_.est.noise_std) * rng.standard_normal(
        (B, T, sys_.est.n_pixels))).astype(np.float32))
    mag = torch.tensor([0.8, 1.0, 1.3])
    ns = torch.tensor([1.0, 0.5, 2.0])
    ref = closed_loop.simulate(sys_.loop, sys_.layers, cfg, None, T,
                               start_step=START, mag=mag, noise_scale=ns,
                               noise_seq=seq)
    ys = sk.run_variant(sys_.loop, sys_.layers, cfg, mag, ns, T, START,
                        None, seq)
    names = ("u", "x_est_norm", "x_pred_norm", "cost", "rms_res", "rms_turb",
             "strehl_exact")
    assert len(ys) == T and all(len(y) == len(names) for y in ys)
    for i, name in enumerate(names):
        torch.testing.assert_close(torch.stack([y[i] for y in ys], dim=1),
                                   getattr(ref, name), rtol=1e-5, atol=0,
                                   msg=name)
    stacked = sk.run_variant(sys_.loop, sys_.layers, cfg, mag, ns, T, START,
                             None, seq, telemetry="stacked")
    for name in ref._fields:
        torch.testing.assert_close(getattr(stacked, name),
                                   getattr(ref, name), rtol=1e-5, atol=0,
                                   msg=name)
    packed = sk.run_variant(sys_.loop, sys_.layers, cfg, mag, ns, T, START,
                            None, seq, telemetry="packed")
    torch.testing.assert_close(packed, torch.cat(
        [ref.u, ref.du, ref.volts, ref.x_est] + [
            getattr(ref, f)[..., None] for f in ref._fields[4:]], dim=-1))
    # knocked-out pieces: no noise is the noise-free loop
    quiet = sk.run_variant(sys_.loop, sys_.layers, cfg, mag, ns, T, START,
                           None, seq, noise_on=False, telemetry=False,
                           rms=False, exact_strehl=False)
    free = closed_loop.simulate(sys_.loop, sys_.layers, cfg, None, T,
                                start_step=START, mag=mag, noise_scale=0.0,
                                noise_seq=seq)
    torch.testing.assert_close(torch.stack([y[0] for y in quiet], dim=1),
                               free.u, rtol=1e-5, atol=0)


def test_knockouts_and_breakdown_report_the_jax_keys(capsys):
    env = {"SK_DEVICE": "cpu", "SB_DEVICE": "cpu"}
    ko = sk.main(["32", "2", "2"], env)
    assert set(ko) == {"R", "B", "steps", "device"} | {
        f"{v}_us" for v in KNOCKOUTS}
    assert set(sk.VARIANTS) == set(KNOCKOUTS)
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == ko
    only = sk.main(["32", "2", "2", "full,lean"], env)
    assert {k for k in only if k.endswith("_us")} == {"full_us", "lean_us"}
    br = sb.main(["32", "2", "2"], env)
    assert set(br) == {"R", "B", "steps", "device", *STAGES}
    assert br["sum_of_parts_us"] == pytest.approx(
        sum(br[k] for k in STAGES[:4]), abs=0.02)
    assert all(br[k] > 0 for k in STAGES) and br["device"] == "cpu"


@pytest.fixture(scope="module")
def flow():
    cfg = reference_config(resolution=32)
    tel = dataclasses.replace(cfg.telescope, resolution=32)
    return edge_flow.build(0, cfg.atmosphere, tel, device="cpu")


def test_breakdown_full_new_is_advance(flow):
    model, state0 = flow
    model_bf = dataclasses.replace(model, A=model.A.to(torch.bfloat16),
                                   Bc=model.Bc.to(torch.bfloat16))
    steps = efb.breakdown_steps(model, model_bf,
                                torch.Generator().manual_seed(3))
    assert set(steps) == {"draws", "draws_embed", "no_frac", "full_new",
                          "full_new_bf16ops"}
    gen = torch.Generator().manual_seed(3)
    phases, st = state0.phases[None], state0
    for idx in range(4):
        phases, tot = steps["full_new"](phases, idx)
        st, ph = edge_flow.advance(model, st, idx, gen)
        torch.testing.assert_close(phases[0], st.phases, rtol=0, atol=0)
        assert float(tot) == pytest.approx(float(ph.sum()), rel=1e-6)
    # the integer-lattice update leaves the state advance leaves
    steps = efb.breakdown_steps(model, model_bf,
                                torch.Generator().manual_seed(5))
    gen = torch.Generator().manual_seed(5)
    phases, st = state0.phases[None], state0
    for idx in range(4):
        phases, _ = steps["no_frac"](phases, idx)
        st, _ = edge_flow.advance(model, st, idx, gen)
        torch.testing.assert_close(phases[0], st.phases, rtol=0, atol=0)


def test_edge_flow_reports_and_staged_resume(tmp_path):
    assert set(efb.not_ported(128)) == {
        "full_old", "full_new_where", "full_hybrid_switch",
        "full_hybrid_where"}
    assert "full_new_switch" in efb.not_ported(512)
    out = str(tmp_path / "efb.json")
    env = {"EFB_DEVICE": "cpu", "EFB_RES": "32", "EFB_STEPS": "2",
           "EFB_REPEATS": "2"}
    first = efb.main([out], dict(env, EFB_SKIP_LOOPS="1"))
    assert set(first["advance_breakdown"]) == {
        "draws", "draws_embed", "no_frac", "full_new", "full_new_bf16ops"}
    assert first["closed_loop"] == {}
    assert set(first["not_ported"]) == set(efb.not_ported(32))
    second = efb.main([out], env)
    assert second["advance_breakdown"] == first["advance_breakdown"]
    assert set(second["closed_loop"]) == {"B=1", "B=4"}
    for row in second["closed_loop"].values():
        assert set(row) == {"periodic", "conditional",
                            "conditional_overhead_us_per_step"}
        for f in ("periodic", "conditional"):
            assert set(row[f]) == {"build_s", "us_per_step",
                                   "us_per_step_per_scen", "iqr_us",
                                   "host_us_per_step", "host_iqr_us"}
    assert json.loads(open(out).read()) == json.loads(json.dumps(second))
    cost = efc.main(["32", "4"], {"EFC_DEVICE": "cpu"})
    assert set(cost) == {"resolution", "steps", "device", "periodic",
                         "conditional", "conditional_overhead_us_per_step"}
    for f in efc.FLOWS:
        assert set(cost[f]) == {"loop_s", "us_per_step", "mean_strehl"}
        assert cost[f]["mean_strehl"] > 0.5


def test_scaling_worlds_of_one_and_two_cpu_ranks(monkeypatch, tmp_path):
    monkeypatch.setattr(scaling, "RESOLUTION", 32)
    out = tmp_path / "scaling.json"
    rep = scaling.main(["2", "3", str(out)], {"SCALING_DEVICE": "cpu",
                                              "SCALING_RANKS": "2"})
    assert json.loads(out.read_text()) == rep
    assert set(rep) == {"platform", "device", "n_devices", "cross_card",
                        "scenarios_per_device", "steps", "solves_per_s",
                        "efficiency"}
    assert rep["platform"] == "cpu" and rep["cross_card"] is False
    assert set(rep["solves_per_s"]) == set(rep["efficiency"]) == {"1", "2"}
    assert rep["efficiency"]["1"] == 1.0
    assert all(v > 0 for v in rep["solves_per_s"].values())
    assert scaling.world_sizes(8) == [1, 4, 8]
