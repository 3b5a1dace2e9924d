"""The staged resume of the port's experiment scripts
(mpc_sensorlessao_tpu_torch/benchmarks): a prior out.json is resumed
only when it was made on the same device with the same knobs that shape
its rows (_protocol.resume_mismatch), and then only its row sections
are merged -- the fresh run's metadata always stands; a prior that does
not match is named on stderr and left out.  edge_flow_breakdown's
closed-loop rows resume a (flow, batch) pair at a time.

The runs here are stubbed where a real one would build a system: the
protocol scripts run with a stage list that names no stage (load, merge
and save alone), excursion_tail's arms and edge_flow_breakdown's timed
runs are replaced by recording stand-ins.
"""

import json
from pathlib import Path

import pytest
import torch

from mpc_sensorlessao_tpu_torch.benchmarks import _protocol as P
from mpc_sensorlessao_tpu_torch.benchmarks import edge_flow_breakdown as efb
from mpc_sensorlessao_tpu_torch.benchmarks import excursion_tail as xt
from mpc_sensorlessao_tpu_torch.benchmarks import protocol_edge as pe
from mpc_sensorlessao_tpu_torch.benchmarks import protocol_sweep as ps
from mpc_sensorlessao_tpu_torch.models import pipeline
from mpc_sensorlessao_tpu_torch.parallel import montecarlo

torch.set_num_threads(1)

CARD = "NVIDIA H100 80GB HBM3, 700.00 W"
ROW = {"mean_strehl": 0.5}


def _plant(path: Path, report: dict, **changes) -> dict:
    prior = dict(report, **changes)
    path.write_text(json.dumps(prior))
    return prior


SWEEP_ENV = {"PROTO_DEVICE": "cpu", "PROTO_TRAIN": "300", "PROTO_STEPS": "4",
             "PROTO_DR0": "5", "PROTO_STAGES": "none"}
# the knobs of a sweep run with SWEEP_ENV at R=32, and a prior's rows
SWEEP_PRIOR = {"protocol": "stale", "resolution": 32, "n_train": 300,
               "n_valid": 50, "n_steps": 4, "device": "cpu",
               "reference_loop_s": 1.0,
               "reference_rows": {"d_over_r0=5": ROW},
               "tuned_rows": {"d_over_r0=5": ROW}}


@pytest.mark.parametrize("changes", [{"device": CARD}, {"n_train": 1000},
                                     {"n_valid": 500}, {"n_steps": 500}],
                         ids=["device", "n_train", "n_valid", "n_steps"])
def test_protocol_sweep_other_prior_is_not_merged(tmp_path, capsys,
                                                  changes):
    """A prior of another device, split or step count: the fresh run's
    metadata stands, none of its rows is merged, and stderr says why."""
    out = tmp_path / "r.json"
    _plant(out, SWEEP_PRIOR, **changes)
    rep = ps.main(["32", str(out)], SWEEP_ENV)
    assert (rep["device"], rep["n_train"], rep["n_valid"],
            rep["n_steps"]) == ("cpu", 300, 50, 4)
    assert rep["reference_rows"] == {} and rep["tuned_rows"] == {}
    assert "reference_loop_s" not in rep and rep["protocol"] != "stale"
    err = capsys.readouterr().err
    assert f"not resuming {out}" in err and next(iter(changes)) in err
    assert json.loads(out.read_text()) == json.loads(json.dumps(rep))


def test_protocol_sweep_matching_prior_merges_rows_only(tmp_path, capsys):
    """A prior of the same device and knobs: its row sections are merged
    as they stand, its metadata is not (the fresh ``protocol`` stands)."""
    out = tmp_path / "r.json"
    _plant(out, SWEEP_PRIOR)
    rep = ps.main(["32", str(out)], SWEEP_ENV)
    for key in ("reference_rows", "tuned_rows", "reference_loop_s"):
        assert rep[key] == SWEEP_PRIOR[key]
    assert rep["protocol"] != "stale"
    assert "not resuming" not in capsys.readouterr().err


EDGE_ENV = {"PE_DEVICE": "cpu", "PE_TRAIN": "300", "PE_STEPS": "4",
            "PE_DR0": "5", "PE_MC_B": "2", "PE_STAGES": "none"}
EDGE_PRIOR = {"protocol": "stale", "resolution": 32, "n_steps": 4,
              "n_train": 300, "n_valid": 50, "device": "cpu",
              "reference_rows": {"d_over_r0=5": ROW},
              "periodic_rows": {"d_over_r0=5": ROW},
              "tuned_rows": {"d_over_r0=5": ROW},
              "monte_carlo": {"batch": 2, "mean_strehl": 0.5},
              "conditional_loop_s": 1.0}


@pytest.mark.parametrize("changes", [
    {"device": CARD}, {"n_train": 1000},
    {"monte_carlo": {"batch": 32, "mean_strehl": 0.5}}],
    ids=["device", "n_train", "mc_batch"])
def test_protocol_edge_other_prior_is_not_merged(tmp_path, capsys, changes):
    """protocol_edge likewise, the Monte-Carlo batch (PE_MC_B, recorded
    in the monte_carlo section) among its knobs."""
    out = tmp_path / "e.json"
    _plant(out, EDGE_PRIOR, **changes)
    rep = pe.main(["32", str(out)], EDGE_ENV)
    assert (rep["device"], rep["n_train"], rep["n_valid"]) == ("cpu", 300,
                                                               50)
    assert rep["reference_rows"] == rep["periodic_rows"] == {}
    assert rep["tuned_rows"] == {}
    assert "monte_carlo" not in rep and "conditional_loop_s" not in rep
    assert rep["protocol"] != "stale"
    assert f"not resuming {out}" in capsys.readouterr().err


def test_protocol_edge_matching_prior_merges_rows_only(tmp_path):
    out = tmp_path / "e.json"
    _plant(out, EDGE_PRIOR)
    rep = pe.main(["32", str(out)], EDGE_ENV)
    for key in ("reference_rows", "periodic_rows", "tuned_rows",
                "monte_carlo", "conditional_loop_s"):
        assert rep[key] == EDGE_PRIOR[key]
    assert rep["protocol"] != "stale"


@pytest.mark.parametrize("changes", [{"n_train": 1000}, {"device": CARD}],
                         ids=["xt_train", "device"])
def test_excursion_tail_other_prior_rows_are_not_merged(tmp_path,
                                                        monkeypatch,
                                                        capsys, changes):
    """Rows made under another XT_TRAIN (or on another card) are not
    merged: every arm runs afresh, and the report holds the fresh rows."""
    out = tmp_path / "t.json"
    env = {"XT_DEVICE": "cpu", "XT_TRAIN": "300", "XT_STEPS": "4",
           "XT_DR0": "15"}
    prior = {"resolution": 32, "n_steps": 4, "n_train": 300, "device": "cpu",
             "rows": {f"d=15_{arm}": {"stale": True, "min_strehl": 0.1,
                                      "p95_rms_res_rad": 2.0}
                      for arm, *_ in xt.ARMS}}
    ran = []

    def arm_row(cfg0, d, order, vmr, dev):
        ran.append(order)
        return {"min_strehl": 0.5, "p95_rms_res_rad": 1.0}
    monkeypatch.setattr(xt, "arm_row", arm_row)
    _plant(out, prior)
    xt.main(["32", str(out)], env)
    assert ran == []                      # the matching prior: resumed
    _plant(out, prior, **changes)
    rep = xt.main(["32", str(out)], env)
    assert ran == [order for _, order, _ in xt.ARMS]
    assert all("stale" not in row for row in rep["rows"].values())
    assert (rep["n_train"], rep["device"]) == (300, "cpu")
    assert f"not resuming {out}" in capsys.readouterr().err


def _stub_loop(monkeypatch):
    """Stand-ins for the builds and runs of efb.loop_marginal, recording
    each (flow, batch) pair measured and each flow built."""
    measured, built = [], []

    def build(cfg, dev):
        built.append(cfg.atmosphere.flow)
        return type("System", (), {"loop": None, "layers": None,
                                   "edge_model": None, "edge_state": None})

    def run_batch(loop, layers, cfg, scen, n_steps, **kw):
        measured.append((cfg.atmosphere.flow, scen))

    def times_ms(fn, dev, repeats):
        fn()
        return [1.0 + i for i in range(repeats)]

    monkeypatch.setattr(P, "times_ms", times_ms)
    monkeypatch.setattr(pipeline, "build", build)
    monkeypatch.setattr(montecarlo, "make_scenarios",
                        lambda cfg, gen, batch, device: batch)
    monkeypatch.setattr(montecarlo, "assert_shared_window", lambda s: None)
    monkeypatch.setattr(montecarlo, "run_batch", run_batch)
    return measured, built


def test_loop_marginal_measures_only_missing_pairs(monkeypatch):
    """A half-done flow: of (periodic, conditional) x (B=1, B=4), with
    both of B=1 and periodic B=4 done, only (conditional, 4) is measured,
    only the conditional flow is built, and the done rows stay as they
    were (the timed run is stubbed: no system is built)."""
    measured, built = _stub_loop(monkeypatch)
    row = {"build_s": 1.0, "us_per_step": 10.0, "us_per_step_per_scen": 10.0,
           "iqr_us": [9.0, 11.0], "host_us_per_step": 12.0,
           "host_iqr_us": [11.0, 13.0]}
    done = {"B=1": {"periodic": dict(row), "conditional": dict(row),
                    "conditional_overhead_us_per_step": 0.0},
            "B=4": {"periodic": dict(row, us_per_step=40.0)}}
    want = json.loads(json.dumps(done))
    saved = []
    out = efb.loop_marginal(32, [1, 4], 2, 2, torch.device("cpu"),
                            done=done, save=lambda o: saved.append(
                                json.loads(json.dumps(o))))
    assert measured == [("conditional", 4)] and built == ["conditional"]
    assert out["B=1"]["periodic"] == want["B=1"]["periodic"]
    assert out["B=1"]["conditional"] == want["B=1"]["conditional"]
    assert out["B=4"]["periodic"] == want["B=4"]["periodic"]
    assert set(out["B=4"]["conditional"]) == set(row)
    assert out["B=4"]["conditional_overhead_us_per_step"] == pytest.approx(
        out["B=4"]["conditional"]["us_per_step"] - 40.0, abs=0.05)
    assert len(saved) == 1
    # everything done: nothing built, nothing measured
    measured.clear(), built.clear()
    efb.loop_marginal(32, [1, 4], 2, 2, torch.device("cpu"), done=out)
    assert measured == [] and built == []


EFB_ENV = {"EFB_DEVICE": "cpu", "EFB_RES": "32", "EFB_STEPS": "2",
           "EFB_REPEATS": "2", "EFB_SKIP_LOOPS": "1"}


@pytest.mark.parametrize("changes", [{"device": CARD}, {"repeats": 9},
                                     {"batch": 128}],
                         ids=["device", "repeats", "batch"])
def test_edge_flow_breakdown_other_prior_is_not_merged(tmp_path,
                                                       monkeypatch, capsys,
                                                       changes):
    """edge_flow_breakdown resumes on the same helper: a prior of another
    device, repeat count or EFB_BATCH is not merged and every breakdown
    row is measured afresh; a matching one is kept whole and nothing is
    measured (the timed runs are stubbed)."""
    timed = []

    def times_ms(fn, dev, repeats):
        timed.append(fn)
        return [1.0] * repeats
    monkeypatch.setattr(P, "times_ms", times_ms)
    out = tmp_path / "efb.json"
    rows = {name: {"us_per_step": 1.0, "iqr_us": [1.0, 1.0]}
            for name in ("draws", "draws_embed", "no_frac", "full_new",
                         "full_new_bf16ops")}
    prior = {"what": "stale", "resolution": 32, "device": "cpu",
             "scan_steps": 2, "repeats": 2, "batch": 64,
             "advance_breakdown": rows, "closed_loop": {}}
    _plant(out, prior)
    rep = efb.main([str(out)], EFB_ENV)
    assert timed == [] and rep["advance_breakdown"] == rows
    assert rep["what"] != "stale"
    _plant(out, prior, **changes)
    rep = efb.main([str(out)], EFB_ENV)
    assert len(timed) == len(rows)
    assert rep["advance_breakdown"] != rows and rep["device"] == "cpu"
    assert (rep["repeats"], rep["batch"]) == (2, 64)
    assert f"not resuming {out}" in capsys.readouterr().err
