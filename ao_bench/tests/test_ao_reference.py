"""The float64 reference, piece by piece, against the port's set-up at a
small grid on the CPU: both must derive the same operators from the
same configuration file (the port rounds them to float32)."""

import json

import numpy as np
import pytest
import torch

from conftest import ROOT
from ao_bench import harness
from ao_bench.reference import optics, system, turbulence

CPU = torch.device("cpu")


def small(name, R=64):
    cfg = json.loads((ROOT / "ao_bench" / "configs" / f"{name}.json")
                     .read_text())
    for g in ("telescope", "estimator"):
        cfg[g]["resolution"] = R
    cfg["sim"].update(n_train=300, n_valid=50, n_test=12)
    return cfg


@pytest.fixture(scope="module", params=["ref512", "strong512"])
def pair(request):
    from mpc_sensorlessao_tpu_torch.models import pipeline
    cfg = small(request.param)
    prog = pipeline.build(harness.program_config(cfg), "cpu")
    return cfg, prog, system.Reference(cfg, CPU)


def rel(a, b):
    a = torch.as_tensor(a, dtype=torch.float64)
    b = torch.as_tensor(b, dtype=torch.float64)
    return float((a - b).abs().max() / b.abs().max())


def test_basis_and_fit(pair):
    _, prog, ref = pair
    assert rel(prog.basis.stack, ref.op.maps) < 1e-6
    assert rel(prog.basis.fit_full, ref.op.fit) < 1e-5


def test_linearised_psf_model_and_gain(pair):
    _, prog, ref = pair
    est = prog.loop.est
    assert rel(est.b_s, ref.b_s) < 1e-5
    assert rel(est.A_s, torch.cat([ref.op.linearise()[1]])) < 1e-5
    assert rel(est.solve_op, ref.gain) < 1e-4
    assert float(est.noise_std) == pytest.approx(ref.sigma, rel=1e-6)


def test_dm_influence(pair):
    _, prog, ref = pair
    assert rel(prog.dm_model.influence, ref.influence) < 1e-5


def test_var_fit_and_controller(pair):
    _, prog, ref = pair
    assert rel(prog.var_model.coefficient(1), ref.mpc.A1) < 1e-3
    assert rel(prog.loop.mats.M1B, ref.M1B) < 1e-3


def test_screens_equal_the_ports():
    from mpc_sensorlessao_tpu_torch.ops import phase_screens
    cfg = small("ref512", R=32)
    pc = harness.program_config(cfg)
    layers = phase_screens.make_layers(0, pc.atmosphere, pc.telescope,
                                       device="cpu")
    ref = turbulence.Screens(0, cfg["atmosphere"], 32, 1.0, 200.0, CPU)
    n = ref.screens.shape[-1]
    assert rel(layers.screens[:, :n, :n], ref.screens) < 1e-6
    steps = np.array([0, 7, 1499], dtype=np.float32)
    want = torch.stack([phase_screens.phase_at(layers, np.float32(s), 32)
                        for s in steps])
    assert rel(want, ref.phase(steps)) < 1e-6


def test_zernike_prior_matches_the_ports_analytic_covariance():
    from mpc_sensorlessao_tpu_torch.ops import zernike_stats
    cfg = small("strong512")
    atm = harness.program_config(cfg).atmosphere
    want = zernike_stats.covariance_analytic(atm, 1.0, 10)
    assert rel(optics.zernike_prior(cfg["atmosphere"], 1.0, 10), want) < 1e-7


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2 ** -10, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11,
                      -(1.0 + 2 ** -11 + 2 ** -20), 3.0e38],
                     dtype=torch.float32)
    got = system.tf32(x).tolist()
    assert got[0] == 1.0 + 2 ** -10          # representable
    assert got[1] == 1.0                     # tie to even
    assert got[2] == 1.0 + 2 ** -9           # tie to even, upward
    assert got[3] == -(1.0 + 2 ** -10)       # above the tie, away from 0
    assert np.isfinite(got[4])
