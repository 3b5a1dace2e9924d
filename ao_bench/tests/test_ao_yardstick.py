"""The benchmark's frozen arithmetic, pinned at the cells' shapes."""

import math

import pytest
import torch

from ao_bench import yardstick


@pytest.mark.parametrize("B, bound_ms",
                         [(2048, 2.567371608), (1024, 1.283685804)])
def test_b1_bound_at_r512(B, bound_ms):
    b = yardstick.measure_bound("sym3", 512, B, 31)
    assert b["limit"] == "tensor"
    assert b["bound_ms"] == pytest.approx(bound_ms, rel=1e-9)
    assert b["tensor_ms"] == pytest.approx(
        1e3 * 3 * yardstick.dft_flops(512, 31, B) / 495e12, rel=1e-12)


def test_b1_bytes_and_fp32_parts_at_r512_b2048():
    b = yardstick.measure_bound("sym3", 512, 2048, 31)
    floats = (2048 + 1 + 2) * 512 * 512 + 2 * 31 * 512 + 3 * 2048 * 31 * 31
    assert b["bytes_ms"] == pytest.approx(1e3 * 4 * floats / 3.35e12)
    assert b["bytes_ms"] == pytest.approx(0.649066832, rel=1e-8)
    assert b["fp32_ms"] == pytest.approx(1e3 * 2048 * 12 * 512 ** 2 / 67e12)


def test_dft_flops_counts_both_stages_of_three_fields():
    R, w = 512, 31
    # three fields, two real products of each complex one in each stage
    per = 3 * 4 * 2 * (w * R * R + w * w * R)
    assert yardstick.dft_flops(R, w, 1) == per


def test_bf16_bound_takes_one_pass_at_the_bf16_rate():
    b = yardstick.measure_bound("sym3", 128, 4096, 31, bf16=True)
    assert b["tensor_ms"] == pytest.approx(
        1e3 * yardstick.dft_flops(128, 31, 4096) / 989e12)


def test_unknown_variant_is_refused():
    with pytest.raises(ValueError):
        yardstick.measure_work("fft", 512, 31, 1)


def test_divergence_rule_keeps_only_finite_bounded_scenarios():
    T = 10
    turb = torch.ones((4, T))
    res = torch.full((4, T), 0.5)
    res[1, T // 2:] = 11.0                 # settled residual above 10x
    res[2, -1] = math.nan                  # non-finite settled telemetry
    res[3, :T // 2] = 100.0                # only the transient is large
    assert yardstick.kept(res, turb).tolist() == [True, False, False, True]
    assert yardstick.settled_from(T) == 5
    assert yardstick.settled_from(1) == 1
