"""The port's CUDA kernels B1-B5 on the card, against their plain versions
(B1-B4 also in their bf16 branch, and at crops wider than 32 px), and the
strong-turbulence recipe (re-linearized Gauss-Newton, the recipe loop),
the general MPC solvers (multi-step Newton-KKT, cyclic reduction,
ramp rows, ADMM, and the loop through each), kernel L1 (the line
search's bank) against its plain version, the conditional-Gaussian
flow (its build and loop, its bf16 border draw) and the sensing path of
the classical comparison (SH and pyramid slopes, the integrator loop, the
detector's noise law, the benchmark's row) on the card against the CPU.

These tests need an NVIDIA GPU with nvcc (marker ``gpu``) and skip
without one.  They import neither jax nor the JAX package, so on the GPU
machine they run without the repo's conftest:

    python -m pytest --noconftest -m gpu tests/test_torch_cuda.py
"""

import dataclasses
import json
import re

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from mpc_sensorlessao_tpu_torch import reference_config, strong_turbulence
from mpc_sensorlessao_tpu_torch.benchmarks import device_peaks
from mpc_sensorlessao_tpu_torch.models import closed_loop, estimator, mpc
from mpc_sensorlessao_tpu_torch.models import pipeline, solvers
from mpc_sensorlessao_tpu_torch.ops import cuda_build, dft, edge_flow
from mpc_sensorlessao_tpu_torch.ops import newton_kkt, phase_screens, psf
from mpc_sensorlessao_tpu_torch.ops import psf_kernels
from mpc_sensorlessao_tpu_torch.ops import zernike
from mpc_sensorlessao_tpu_torch.utils import profiling, tree


@pytest.fixture
def cuda_device():
    """The first CUDA device, with TF32 off; skips without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda:0")


def _b1_args(R, B, c, dev, seed=0, a=3.0):
    rng = np.random.default_rng(seed)
    phase = torch.as_tensor(
        (rng.normal(size=(B, R, R)) * 0.4).astype(np.float32), device=dev)
    z4 = zernike.make_basis(6, R, device=dev).stack[4]
    return (phase, psf.pupil_mask(R, device=dev), torch.cos(a * z4),
            torch.sin(a * z4), dft.centered_partial_dft(R, c, device=dev),
            2.0)


@pytest.mark.gpu
@pytest.mark.parametrize("R,B,c", [(64, 5, 9), (128, 16, 15), (100, 3, 15),
                                   (512, 2, 15), (128, 1, 15), (98, 3, 15)])
def test_b1_cuda_kernel_matches_plain(cuda_device, R, B, c):
    """Kernel B1 vs its plain version on the card, including grids that
    are not a multiple of the 32-px tile (R=98 also not of 4, so the maps
    reach shared memory in 4-byte copies), a crop narrower than a warp
    and a single scenario: rtol 2e-4; atol 1e-5 of the batch's peak (both sum
    R^2 unit-modulus terms in float32 in different orders -- B1 in 3xTF32
    on the tensor cores -- an error that scales with the peak
    amplitude)."""
    args = _b1_args(R, B, c, cuda_device)
    before = psf_kernels.psf_crop_diversity_sym3.launches
    got = psf_kernels.psf_crop_diversity_sym3(*args)
    torch.cuda.synchronize()
    assert psf_kernels.psf_crop_diversity_sym3.launches == before + 1
    want = psf_kernels.psf_crop_diversity_sym3_ref(*args)
    assert got.shape == (B, 3, 2 * c + 1, 2 * c + 1)
    peak = float(want.abs().max())
    torch.testing.assert_close(got, want, rtol=2e-4, atol=1e-5 * peak)


# B1 float32's max error against its plain version, of the peak, at
# R <= 128 and at R=512: the mma.sync design's (ROADMAP C.3, chip_smoke.py
# F32_ATOL), which its wgmma design keeps, and B4's on the same policy
B1_F32_ATOL = {128: 2.0e-6, 512: 3.8e-6}
# B1's and B4's bf16 entries against their bf16 plain versions, of the
# peak (chip_smoke.py's BF16_ATOL)
BF16_ATOL = 4e-5


@pytest.mark.gpu
@pytest.mark.parametrize("R,B,c", [(128, 1, 15), (128, 5, 15), (98, 3, 15),
                                   (512, 4, 15), (128, 3, 20)])
def test_b1_wgmma_within_the_mma_sync_designs_error(cuda_device, R, B, c):
    """B1 float32 on the wgmma engine (3xTF32) vs its plain version on the
    card: one scenario, an odd count (the last pair's second consumer
    stores nothing), R=98 (rows copied in 4 bytes, not by TMA), R=512
    and a 41-px crop (two bands) each within the mma.sync design's error
    (B1_F32_ATOL of the peak), and each call counted once."""
    args = _b1_args(R, B, c, cuda_device)
    before = psf_kernels.psf_crop_diversity_sym3.launches
    got = psf_kernels.psf_crop_diversity_sym3(*args)
    psf_kernels.psf_crop_diversity_sym3(*args)
    torch.cuda.synchronize()
    assert psf_kernels.psf_crop_diversity_sym3.launches == before + 2
    want = psf_kernels.psf_crop_diversity_sym3_ref(*args)
    assert got.shape == want.shape == (B, 3, 2 * c + 1, 2 * c + 1)
    peak = float(want.abs().max())
    err = float((got - want).abs().max())
    assert err <= B1_F32_ATOL[128 if R <= 128 else 512] * peak, (err, peak)


@pytest.mark.gpu
@pytest.mark.parametrize("R,B,c", [(128, 1, 15), (128, 5, 15), (98, 3, 15),
                                   (512, 4, 15), (128, 3, 20)])
def test_b4_wgmma_within_b1s_limits_and_equal_to_b1(cuda_device, R, B, c):
    """B4 on the wgmma engine, B1's sym3 policy under its own entries:
    its float32 output within B1's limit of its plain version
    (B1_F32_ATOL of the peak) and its bf16 output within BF16_ATOL of its
    bf16 plain version, on B1's shapes, each equal to B1's output on the
    same inputs bit for bit, and each call counted in B4's wrapper, not
    in B1's."""
    args = _b1_args(R, B, c, cuda_device)
    b1, b4 = (psf_kernels.psf_crop_diversity_sym3,
              psf_kernels.psf_crop_diversity_sym3_thin)
    for dtype, limit in ((None, B1_F32_ATOL[128 if R <= 128 else 512]),
                         ("bfloat16", BF16_ATOL)):
        before = (b1.launches, b1.launches_bf16, b4.launches,
                  b4.launches_bf16)
        got = b4(*args, compute_dtype=dtype)
        torch.cuda.synchronize()
        bf = dtype is not None
        assert (b1.launches, b1.launches_bf16, b4.launches,
                b4.launches_bf16) == (before[0], before[1],
                                      before[2] + (not bf), before[3] + bf)
        want = psf_kernels.psf_crop_diversity_sym3_thin_ref(
            *args, compute_dtype=dtype)
        assert got.shape == want.shape == (B, 3, 2 * c + 1, 2 * c + 1)
        peak = float(want.abs().max())
        err = float((got - want).abs().max())
        assert err <= limit * peak, (dtype, err, peak)
        same = b1(*args, compute_dtype=dtype)
        torch.cuda.synchronize()
        assert torch.equal(got.view(torch.int32), same.view(torch.int32))


@pytest.mark.gpu
def test_b1_float32_takes_an_r_its_bf16_entry_refuses(cuda_device):
    """B1 float32 streams its operator through a fixed shared-memory ring,
    so no R is past its limit: at R=1152 it launches and meets the
    float32 limits, while the bf16 entry, which holds the operator whole,
    is refused there (above R=1088) and its wrapper raises without
    counting a launch."""
    args = _b1_args(1152, 1, 15, cuda_device)
    k = psf_kernels.psf_crop_diversity_sym3
    before = (k.launches, k.launches_bf16)
    got = k(*args)
    torch.cuda.synchronize()
    want = psf_kernels.psf_crop_diversity_sym3_ref(*args)
    peak = float(want.abs().max())
    torch.testing.assert_close(got, want, rtol=2e-4, atol=1e-5 * peak)
    with pytest.raises(RuntimeError, match="psf_div3_sym_bf16"):
        k(*args, compute_dtype="bfloat16")
    assert (k.launches, k.launches_bf16) == (before[0] + 1, before[1])


# B2's and B3's float32 max error against their plain versions, of the
# peak, at R <= 128 and at R=512: the mma.sync design's on chip_smoke.py's
# inputs (its F32_ATOL; NVIDIA H100 80GB HBM3, 700 W), which their wgmma
# design keeps -- on the triple (B2, B3) and on random maps (B2)
B2_B3_F32_ATOL = {"triple": {128: 2.01e-6, 512: 3.78e-6},
                  "random": {128: 2.08e-6, 512: 4.41e-6}}


@pytest.mark.gpu
@pytest.mark.parametrize("kernel,n_div", [("b2", 3), ("b2", 5), ("b3", 3)])
@pytest.mark.parametrize("R,B,c", [(128, 1, 15), (128, 5, 15), (98, 3, 15),
                                   (512, 4, 15), (128, 3, 20), (128, 3, 31)])
def test_b2_b3_wgmma_within_the_mma_sync_designs_error(cuda_device, kernel,
                                                       n_div, R, B, c):
    """B2 (on the symmetric triple, and on 5 random maps: a group of 3 and
    a ragged one of 2) and B3 (on the 3 B total phases) float32 on the
    wgmma engine (3xTF32) vs their plain versions on the card: one
    scenario, an odd count (the last pair's second consumer stores
    nothing), R=98 (rows copied in 4 bytes, not by TMA), R=512, and 41-
    and 63-px crops (two bands), each within the mma.sync design's error
    (B2_B3_F32_ATOL of the peak), and each call counted once."""
    wrapper, plain, args = _kernel_args(kernel, R, B, c, cuda_device, n_div)
    before = wrapper.launches
    got = wrapper(*args)
    wrapper(*args)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 2
    want = plain(*args)
    assert got.shape == want.shape
    assert got.shape[-2:] == (2 * c + 1, 2 * c + 1)
    peak = float(want.abs().max())
    err = float((got - want).abs().max())
    limit = B2_B3_F32_ATOL["triple" if n_div == 3 else "random"]
    assert err <= limit[128 if R <= 128 else 512] * peak, (err, peak)


@pytest.mark.gpu
@pytest.mark.parametrize("kernel,entry", [("b2", "psf_div_bf16"),
                                          ("b3", "psf_crop_bf16")])
def test_b2_b3_float32_take_an_r_their_bf16_entries_refuse(cuda_device,
                                                           kernel, entry):
    """B2 and B3 float32 stream their operator through the same fixed
    shared-memory ring as B1, so at R=1152 they launch and meet the
    float32 limits, while their bf16 entries, which hold the operator
    whole, are refused there (above R=896 and 960) and the wrapper raises
    without counting a launch."""
    wrapper, plain, args = _kernel_args(kernel, 1152, 1, 15, cuda_device)
    before = (wrapper.launches, wrapper.launches_bf16)
    got = wrapper(*args)
    torch.cuda.synchronize()
    want = plain(*args)
    peak = float(want.abs().max())
    torch.testing.assert_close(got, want, rtol=2e-4, atol=1e-5 * peak)
    with pytest.raises(RuntimeError, match=entry):
        wrapper(*args, compute_dtype="bfloat16")
    assert (wrapper.launches, wrapper.launches_bf16) == (before[0] + 1,
                                                         before[1])


# libraries whose float32 and bf16 entries run the wgmma engine
# csrc/psf_wgmma.cuh: B1-B4's (B4 on B1's sym3 policy)
WGMMA_LIBS = ["psf_div3_sym", "psf_div", "psf_crop", "psf_div3_sym_thin"]
# TF32 warpgroup products (wgmma): the float32 entries
TF32_HGMMA = re.compile(r"\bHGMMA\.64x\d+x8\.F32\.TF32\b")


def _on_wgmma(lib: str, fn: str) -> bool:
    """Whether kernel ``fn`` of ``lib`` is one of its entries on the
    wgmma engine, float32 or bf16 (not its operator-image kernels)."""
    return f"{lib}_kernel" in fn or f"{lib}_bf16_kernel" in fn


@pytest.mark.gpu
@pytest.mark.parametrize("lib", WGMMA_LIBS)
def test_b1_runs_on_the_tensor_cores_without_spills(cuda_device, lib):
    """The built SASS of B1, B2, B3 and B4 holds TF32 warpgroup products
    (HGMMA.64xNx8.F32.TF32) and no HMMA, and ptxas reports no spill for
    any of a library's kernels: its float32 and bf16 entries, one
    384-thread block an SM, within 168 registers a thread, its
    operator-image kernels within 128."""
    res = cuda_build.ptxas_resources(cuda_build.ptxas_report(lib))
    assert any(f"{lib}_kernel" in fn for fn in res)
    for fn, r in res.items():
        assert r["spill_stores"] == 0 and r["spill_loads"] == 0, (fn, r)
        assert r["registers"] <= (168 if _on_wgmma(lib, fn) else 128), (fn,
                                                                          r)
    sass = device_peaks.sass(lib)
    assert TF32_HGMMA.search(sass) and not re.findall(r"\bHMMA\.", sass)


def _kernel_args(kernel, R, B, c, dev, n_div=3):
    """(wrapper, plain version, arguments) of kernel B2, B3 or B4 on
    speckled phases with the real defocus diversity (a = 3); B2 on
    n_div maps (the symmetric triple for 3, random maps otherwise), B3 on
    the (B*3, R, R) total phases."""
    phase, pupil, cos_a, sin_a, op, scale = _b1_args(R, B, c, dev)
    k = psf_kernels
    if kernel == "b4":
        return (k.psf_crop_diversity_sym3_thin,
                k.psf_crop_diversity_sym3_thin_ref,
                (phase, pupil, cos_a, sin_a, op, scale))
    z4 = zernike.make_basis(6, R, device=dev).stack[4]
    if n_div == 3:
        div = torch.stack([-3.0 * z4, 0.0 * z4, 3.0 * z4])
    else:
        rng = np.random.default_rng(7)
        div = torch.as_tensor((rng.normal(size=(n_div, R, R)) * 0.8).astype(
            np.float32), device=dev)
    if kernel == "b2":
        return (k.psf_crop_diversity, k.psf_crop_diversity_ref,
                (phase, pupil, torch.cos(div), torch.sin(div), op, scale))
    total = (phase[:, None] + div).reshape(-1, R, R)
    return (k.psf_crop_intensity, k.psf_crop_intensity_ref,
            (total, pupil, op, scale))


@pytest.mark.gpu
@pytest.mark.parametrize("kernel,n_div", [("b2", 3), ("b2", 5), ("b3", 3),
                                          ("b4", 3)])
@pytest.mark.parametrize("R,B,c", [(64, 5, 9), (128, 16, 15), (100, 3, 15),
                                   (512, 2, 15)])
def test_b2_b3_b4_cuda_kernels_match_plain(cuda_device, kernel, n_div, R, B,
                                           c):
    """Kernels B2 (3 and 5 maps), B3 and B4 vs their plain versions on
    the card, on B1's grid of shapes: rtol 2e-4; atol 1e-5 of the
    batch's peak (as B1)."""
    wrapper, plain, args = _kernel_args(kernel, R, B, c, cuda_device, n_div)
    before = wrapper.launches
    got = wrapper(*args)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    want = plain(*args)
    assert got.shape == want.shape
    assert got.shape[-2:] == (2 * c + 1, 2 * c + 1)
    peak = float(want.abs().max())
    torch.testing.assert_close(got, want, rtol=2e-4, atol=1e-5 * peak)


@pytest.mark.gpu
@pytest.mark.parametrize("R", [98, 128])
@pytest.mark.parametrize("kernel,count", [("b2", 1), ("b2", 2), ("b2", 4),
                                          ("b3", 1), ("b3", 7)])
def test_b2_b3_ragged_groups_match_plain(cuda_device, kernel, count, R):
    """B2 on n_div = 1, 2, 4 random maps and B3 on N = 1, 7 total phases:
    a group of fewer than three diversities, or a last triple of fewer
    than three items, reads a present map in place of each missing one
    and stores nothing for it.  R=98 is a ragged edge of the 32-px stage
    and not a multiple of 4 (4-byte map copies).  rtol 2e-4; atol 1e-5
    of the peak (as B1)."""
    phase, pupil, _, _, op, scale = _b1_args(R, 3, 15, cuda_device)
    rng = np.random.default_rng(8)
    maps = torch.as_tensor((rng.normal(size=(count, R, R)) * 0.8).astype(
        np.float32), device=cuda_device)
    k = psf_kernels
    if kernel == "b2":
        wrapper, plain = k.psf_crop_diversity, k.psf_crop_diversity_ref
        args = (phase, pupil, torch.cos(maps), torch.sin(maps), op, scale)
        shape = (3, count, 31, 31)
    else:
        wrapper, plain = k.psf_crop_intensity, k.psf_crop_intensity_ref
        args = (maps, pupil, op, scale)
        shape = (count, 31, 31)
    before = wrapper.launches
    got = wrapper(*args)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    want = plain(*args)
    assert got.shape == want.shape == shape
    peak = float(want.abs().max())
    torch.testing.assert_close(got, want, rtol=2e-4, atol=1e-5 * peak)


# bf16 warpgroup products (wgmma): the bf16 entries, csrc/psf_wgmma.cuh
BF16_HGMMA = re.compile(r"\bHGMMA\.64x\d+x16\.F32\.BF16\b")


@pytest.mark.gpu
@pytest.mark.parametrize("lib", WGMMA_LIBS)
def test_bf16_entries_build_without_spills_on_bf16_mma(cuda_device, lib):
    """Each library's bf16 kernel builds without a spill, on the wgmma
    engine within the 168 registers a thread of its 384-thread block
    starts with (setmaxnreg then moves them between its warpgroups), and
    its SASS holds bf16 warpgroup products (HGMMA.64xNx16.F32.BF16) and
    no HMMA -- B4's as B1's, on the same policy.  The float32 kernel
    beside each holds TF32 ones and no bf16 product."""
    res = cuda_build.ptxas_resources(cuda_build.ptxas_report(lib))
    bf16 = [fn for fn in res if f"{lib}_bf16_kernel" in fn]
    assert len(bf16) == 1, res
    r = res[bf16[0]]
    assert r["spill_stores"] == 0 and r["spill_loads"] == 0, r
    assert r["registers"] <= 168, r
    funcs = device_peaks.sass_functions(device_peaks.sass(lib))
    for fn, text in funcs.items():
        if f"{lib}_bf16_kernel" in fn:
            assert BF16_HGMMA.search(text) and "HMMA" not in text
        elif _on_wgmma(lib, fn):
            assert TF32_HGMMA.search(text) and "HMMA" not in text
            assert not BF16_HGMMA.search(text)


@pytest.mark.gpu
@pytest.mark.parametrize("R", [98, 128])
@pytest.mark.parametrize("kernel,count", [("b1", 3), ("b2", 1), ("b2", 2),
                                          ("b2", 3), ("b2", 4), ("b3", 1),
                                          ("b3", 7), ("b4", 3)])
def test_bf16_cuda_kernels_match_bf16_plain(cuda_device, kernel, count, R):
    """Each kernel's bf16 entry (compute_dtype="bfloat16") vs its plain
    version's bf16 branch on the card, with the ragged groups of the
    float32 tests: B2 on n_div = 1, 2, 4 random maps and on the symmetric
    triple (3), B3 on N = 1, 7 total phases, B1 and B4 on the real
    diversity; R=98 is a ragged edge of the tile and not a multiple of 4.  The launch counts as a bf16 one, not
    a float32 one.  Max abs error at most 4e-5 of the peak on the real
    diversity (B1, B4, B2 on the triple: chip_smoke.py's BF16_ATOL, below the
    6e-5 by which a B1 kernel rounding its +- fields would miss at R=128)
    and 1e-4 on random maps and phases -- the tensor cores' stage-1 sums
    round toward zero and flip the bf16 rounding of a stage-1 element now
    and then, by more on speckle -- and at most 1/4 of the bf16 plain
    version's gap from the float32 one: the kernel computes the bf16
    function."""
    phase, pupil, cos_a, sin_a, op, scale = _b1_args(R, 3, 15, cuda_device)
    k = psf_kernels
    if kernel in ("b1", "b4"):
        wrapper, plain = {
            "b1": (k.psf_crop_diversity_sym3, k.psf_crop_diversity_sym3_ref),
            "b4": (k.psf_crop_diversity_sym3_thin,
                   k.psf_crop_diversity_sym3_thin_ref)}[kernel]
        args = (phase, pupil, cos_a, sin_a, op, scale)
    else:
        if count == 3:
            z4 = zernike.make_basis(6, R, device=cuda_device).stack[4]
            maps = torch.stack([-3.0 * z4, 0.0 * z4, 3.0 * z4])
        else:
            rng = np.random.default_rng(8)
            maps = torch.as_tensor((rng.normal(size=(count, R, R)) * 0.8
                                    ).astype(np.float32), device=cuda_device)
        if kernel == "b2":
            wrapper, plain = k.psf_crop_diversity, k.psf_crop_diversity_ref
            args = (phase, pupil, torch.cos(maps), torch.sin(maps), op,
                    scale)
        else:
            wrapper, plain = k.psf_crop_intensity, k.psf_crop_intensity_ref
            args = (maps, pupil, op, scale)
    before = (wrapper.launches, wrapper.launches_bf16)
    got = wrapper(*args, compute_dtype="bfloat16")
    torch.cuda.synchronize()
    assert (wrapper.launches, wrapper.launches_bf16) == (before[0],
                                                         before[1] + 1)
    want = plain(*args, compute_dtype="bfloat16")
    assert got.shape == want.shape
    assert got.shape[-2:] == (31, 31)
    peak = float(want.abs().max())
    err = float((got - want).abs().max())
    gap = float((want - plain(*args)).abs().max())
    real_diversity = kernel in ("b1", "b4") or (kernel == "b2" and count == 3)
    assert err <= (4e-5 if real_diversity else 1e-4) * peak, (err, peak)
    assert err <= gap / 4, (err, gap)


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["b1", "b2", "b3", "b4"])
def test_wrappers_raise_on_bad_input(cuda_device, kernel):
    """On a CUDA tensor each wrapper launches or raises: a float64 phase,
    a phase on another grid than the maps and an operator of another grid
    are refused, not rerouted."""
    if kernel == "b1":
        wrapper = psf_kernels.psf_crop_diversity_sym3
        args = list(_b1_args(64, 2, 9, cuda_device))
    else:
        wrapper, _, args = _kernel_args(kernel, 64, 2, 9, cuda_device)
        args = list(args)
    before = wrapper.launches
    with pytest.raises(TypeError, match="float32"):
        wrapper(args[0].double(), *args[1:])
    with pytest.raises(ValueError, match="shape"):
        wrapper(args[0][:, :32, :32].contiguous(), *args[1:])
    args[-2] = dft.centered_partial_dft(96, 9, device=cuda_device)
    with pytest.raises(ValueError, match="shape"):
        wrapper(*args)
    assert wrapper.launches == before


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [None, "bfloat16"])
@pytest.mark.parametrize("w", [33, 41, 63])
@pytest.mark.parametrize("kernel", ["b1", "b2", "b3", "b4"])
def test_cuda_kernels_match_plain_at_wide_crops(cuda_device, kernel, w,
                                                dtype):
    """B1-B4 at crops wider than one 32-px band of the engine (w = 33, 41,
    63: two bands, the second ragged) vs their plain versions on the card,
    R=128, B=3 (B2 on the symmetric triple, B3 on the 9 total phases),
    float32 and bf16: the kernel launches (counted in its precision) and
    meets the limits of the 31-px tests -- float32 rtol 2e-4, atol 1e-5
    of the peak; bf16 4e-5 of the peak (real diversity) and 1/4 of the
    bf16 plain version's gap from float32."""
    c = (w - 1) // 2
    if kernel == "b1":
        wrapper = psf_kernels.psf_crop_diversity_sym3
        plain = psf_kernels.psf_crop_diversity_sym3_ref
        args = _b1_args(128, 3, c, cuda_device)
    else:
        wrapper, plain, args = _kernel_args(kernel, 128, 3, c, cuda_device)
    bf16 = dtype is not None
    before = (wrapper.launches, wrapper.launches_bf16)
    got = wrapper(*args, compute_dtype=dtype)
    torch.cuda.synchronize()
    assert (wrapper.launches, wrapper.launches_bf16) == (
        before[0] + (not bf16), before[1] + bf16)
    want = plain(*args, compute_dtype=dtype)
    assert got.shape == want.shape and got.shape[-2:] == (w, w)
    peak = float(want.abs().max())
    if not bf16:
        torch.testing.assert_close(got, want, rtol=2e-4, atol=1e-5 * peak)
        return
    err = float((got - want).abs().max())
    gap = float((want - plain(*args)).abs().max())
    assert err <= 4e-5 * peak, (err, peak)
    assert err <= gap / 4, (err, gap)


@pytest.mark.gpu
def test_estimator_build_on_cuda_takes_wide_crops(cuda_device):
    """estimator.build(..., device="cuda") at crop_half=20 (41-px crops)
    builds, and its measure launches kernel B1 once and matches the CPU
    build's measure (plain version): rtol 2e-4, atol 1e-5 of the peak."""
    cfg = reference_config(resolution=64)
    est_cfg = dataclasses.replace(cfg.estimator, crop_half=20)
    model = estimator.build(
        est_cfg, zernike.make_basis(6, 64, device=cuda_device),
        device=cuda_device)
    ref = estimator.build(est_cfg, zernike.make_basis(6, 64, device="cpu"),
                          device="cpu")
    rng = np.random.default_rng(9)
    ph = torch.as_tensor((rng.normal(size=(4, 64, 64)) * 0.3).astype(
        np.float32))
    b1 = psf_kernels.psf_crop_diversity_sym3
    before = b1.launches
    got = estimator.measure(model, ph.to(cuda_device))
    torch.cuda.synchronize()
    assert b1.launches == before + 1
    want = estimator.measure(ref, ph)
    assert got.shape == want.shape == (4, 3 * 41 * 41)
    torch.testing.assert_close(got.cpu(), want, rtol=2e-4,
                               atol=1e-5 * float(want.abs().max()))


CHAINS = {"b5a": (device_peaks.transc_sincos_chain,
                  device_peaks.transc_sincos_chain_ref, "transc_sincos"),
          "b5b": (device_peaks.transc_cos_chain,
                  device_peaks.transc_cos_chain_ref, "transc_cos")}


# kernel T1's steps: negative, fractional and past the screens' period
T1_STEPS = (-1234.5, 3.375, 1e5 + 0.25, -0.75, 2047.9, 0.0, 517.125, 4.5e5)


def _t1_args(R, B, dev):
    cfg = reference_config(resolution=R)
    tel = dataclasses.replace(cfg.telescope, resolution=R)
    layers = phase_screens.make_layers(3, cfg.atmosphere, tel, device=dev)
    mask = zernike.make_basis(1, R, device=dev).mask
    npix = torch.tensor(float(mask.sum()), device=dev)
    step = torch.tensor(T1_STEPS[:B], dtype=torch.float32, device=dev)
    return layers, step, R, mask, npix


def _t1_kernel_mean(raw, got, mask):
    """The float32 mean the kernel subtracted in each scenario: of the
    float32 values next to the median of raw - got over the pupil, the one
    with which fl(raw - mean) gives the most of the kernel's pixels."""
    d = (raw.double() - got.double())[:, mask]
    mid = d.median(dim=1).values.float()
    cands = [mid]
    for _ in range(4):
        cands = ([torch.nextafter(cands[0], cands[0] - 1)] + cands
                 + [torch.nextafter(cands[-1], cands[-1] + 1)])
    cands = torch.stack(cands, dim=1)                         # (B, 9)
    hits = ((raw[:, mask][:, None, :] - cands[..., None])
            == got[:, mask][:, None, :]).sum(dim=-1)
    return cands.gather(1, hits.argmax(dim=1, keepdim=True))[:, 0]


@pytest.mark.gpu
@pytest.mark.parametrize("R,B", [(512, 8), (32, 5), (64, 5), (98, 3),
                                 (720, 2)])
def test_t1_cuda_kernel_matches_plain(cuda_device, R, B):
    """Kernel T1 against its plain version on the card: 0 outside the
    pupil; inside it the two differ by the difference of their means and
    the rounding of the subtraction alone (within 1 ulp of the larger
    value), so the blend and the layer sum are the plain version's; the
    means agree to 1e-6 of max |raw| (the mean's sum is taken in another
    order).  R=98 is not a whole number of the kernel's 8-row blocks (its
    copies go a byte or a float at a time); at R=720 a CTA's rows do not
    fit in shared memory and are kept in the output."""
    args = _t1_args(R, B, cuda_device)
    layers, step, _, mask, npix = args
    before = phase_screens.piston_removed_phase_at.launches
    got = phase_screens.piston_removed_phase_at(*args)
    torch.cuda.synchronize()
    assert phase_screens.piston_removed_phase_at.launches == before + 1
    want = phase_screens.piston_removed_phase_at_ref(*args)
    assert got.shape == want.shape == (B, R, R)
    assert bool((got[:, ~mask] == 0).all())
    raw = phase_screens.phase_at(layers, step, R)
    mean_plain = (torch.sum(raw * mask.float(), dim=(-2, -1)) / npix)
    mean_kernel = _t1_kernel_mean(raw, got, mask)
    gap = ((got.double() - want.double())[:, mask]
           - (mean_plain.double() - mean_kernel.double())[:, None])
    big = torch.maximum(got.abs(), want.abs())[:, mask]
    ulp = (torch.nextafter(big, big + 1) - big).double()
    assert bool((gap.abs() <= ulp).all()), float((gap.abs() / ulp).max())
    top = raw.abs().amax(dim=(-2, -1)).double()
    assert bool(((mean_plain.double() - mean_kernel.double()).abs()
                 <= 1e-6 * top).all())


@pytest.mark.gpu
def test_t1_wrapper_raises_on_bad_input(cuda_device):
    """On a CUDA tensor T1's entry point launches or raises: a float64,
    a non-contiguous or a wrongly shaped step, and a mask of another
    grid, are refused, not rerouted."""
    layers, step, R, mask, npix = _t1_args(32, 4, cuda_device)
    f = phase_screens.piston_removed_phase_at
    before = f.launches
    with pytest.raises(TypeError, match="float32"):
        f(layers, step.double(), R, mask, npix)
    with pytest.raises(ValueError, match="contiguous"):
        f(layers, torch.stack([step, step], dim=1)[:, 0], R, mask, npix)
    with pytest.raises(ValueError, match=r"\(B,\)"):
        f(layers, step[:, None], R, mask, npix)
    with pytest.raises(ValueError, match="shape"):
        f(layers, step, R, mask[:-1], npix)
    with pytest.raises(TypeError, match="bool"):
        f(layers, step, R, mask.float(), npix)
    assert f.launches == before


def _l1_problem(T, n, B, dev, seed=0, dtype=torch.float32):
    """A seeded VAR(2) fastMPC problem over n states and the cells' 144
    controls (their weights and box) at horizon T on ``dev``,
    with its fixed-Newton operators, and B scenarios from well inside
    the box to far past it (blocks of 8 at 0.1, 1, 10 and 100 times a
    normal draw), so that the line search takes the full step in some and
    backtracks in others: (prob, op, x0, x0_pre, w), in ``dtype``."""
    m = 144
    rng = np.random.default_rng(seed)

    def normal(*shape):
        return torch.as_tensor(rng.normal(size=shape), device=dev)

    eye = torch.eye(n, dtype=torch.float64, device=dev)
    prob = solvers.make_fastmpc_problem(
        0.6 * eye + 0.08 / np.sqrt(n) * normal(n, n),
        0.25 * eye + 0.05 / np.sqrt(n) * normal(n, n), 0.4 * normal(n, m),
        q_weight=15000.0, p_weight=15000.0, r_weight=30.0, u_max=28.0,
        barrier_k=0.01)
    op = newton_kkt.precompute_fixed_newton(prob, T)
    scale = torch.as_tensor(np.resize(np.repeat([0.1, 1.0, 10.0, 100.0], 8),
                                      B), device=dev)[:, None]
    data = (scale * normal(B, n), scale * normal(B, n),
            scale * normal(B, T * n))
    return (tree.cast(prob, dtype), tree.cast(op, dtype),
            *(v.to(dtype) for v in data))


def _l1_args(T, n, B, dev, seed=0, dtype=torch.float32):
    """Kernel L1's arguments at ``solve_fixed``'s line search of
    ``_l1_problem``: the eight (B, T, .) vectors, then the box and the
    barrier weight."""
    prob, op, *data = _l1_problem(T, n, B, dev, seed, dtype)
    b = newton_kkt.equality_rhs(prob, *data, T)
    terms = newton_kkt.line_search_terms(
        prob, b, newton_kkt.init_state(prob, T),
        newton_kkt.fixed_newton_direction(prob, op, b))
    return (*terms, prob.u_min, prob.u_max, prob.barrier_k)


@pytest.mark.gpu
@pytest.mark.parametrize("B", [2048, 37])
@pytest.mark.parametrize("T,n", [(2, 27), (2, 65), (32, 119)])
def test_l1_cuda_kernel_matches_plain(cuda_device, T, n, B):
    """Kernel L1 against its plain version on the card at the cells'
    shapes (N=2 over 27 and 65 states, N=32 over 119; 144 controls) and
    a ragged batch: the same picked candidate and step in every
    scenario, and the 17 norms within 1e-5 of their own values (each
    element's arithmetic is the plain version's; only the order of the
    sums differs)."""
    args = _l1_args(T, n, B, cuda_device)
    before = newton_kkt.line_search_bank.launches
    idx, t, norms = newton_kkt.line_search_bank(*args)
    torch.cuda.synchronize()
    assert newton_kkt.line_search_bank.launches == before + 1
    want_idx, want_t, want_norms = newton_kkt.line_search_bank_ref(*args)
    assert idx.dtype == torch.int32 and idx.shape == t.shape == (B,)
    assert norms.shape == (B, newton_kkt.LS_CANDIDATES + 1)
    # the full step in some scenarios, a backtrack in others
    assert bool((want_idx == 0).any()) and bool((want_idx > 0).any())
    assert torch.equal(idx.long(), want_idx)
    assert torch.equal(t, want_t)
    torch.testing.assert_close(norms, want_norms, rtol=1e-5, atol=0.0)


@pytest.mark.gpu
@pytest.mark.parametrize("T,n", [(2, 27), (32, 119)])
def test_l1_float64_matches_plain(cuda_device, T, n):
    """L1's float64 instance against the plain version in float64 on the
    card: the same pick and step in every scenario of a ragged batch, the
    norms within 1e-12 of their own values, the outputs float64."""
    args = _l1_args(T, n, 37, cuda_device, dtype=torch.float64)
    before = newton_kkt.line_search_bank.launches
    idx, t, norms = newton_kkt.line_search_bank(*args)
    torch.cuda.synchronize()
    assert newton_kkt.line_search_bank.launches == before + 1
    want_idx, want_t, want_norms = newton_kkt.line_search_bank_ref(*args)
    assert t.dtype == norms.dtype == torch.float64
    assert bool((want_idx == 0).any()) and bool((want_idx > 0).any())
    assert torch.equal(idx.long(), want_idx)
    assert torch.equal(t, want_t)
    torch.testing.assert_close(norms, want_norms, rtol=1e-12, atol=0.0)


@pytest.mark.gpu
def test_l1_falls_back_to_the_smallest_step(cuda_device):
    """Scenarios whose direction leaves the box at every t of the bank
    take the smallest step, 1/2^15 (index 15), as the plain version
    does."""
    U, dU, *rest = _l1_args(2, 27, 37, cuda_device)
    dU = dU.clone()
    dU[:3, 0, 0] = 1e9
    idx, t, _ = newton_kkt.line_search_bank(U, dU, *rest)
    want_idx, _, _ = newton_kkt.line_search_bank_ref(U, dU, *rest)
    last = newton_kkt.LS_CANDIDATES - 1
    assert idx[:3].tolist() == want_idx[:3].tolist() == [last] * 3
    assert t[:3].tolist() == [0.5 ** last] * 3
    assert torch.equal(idx.long(), want_idx)


@pytest.mark.gpu
def test_l1_wrapper_raises_on_bad_input(cuda_device):
    """L1's entry point launches or raises: half precision, mixed
    dtypes, CPU, wrongly shaped (also a (T, .) row for a (B, T, .)
    vector) and non-contiguous data are refused, not rerouted; each
    accepted call counts one launch."""
    args = _l1_args(2, 27, 5, cuda_device)
    f = newton_kkt.line_search_bank
    before = f.launches
    with pytest.raises(TypeError, match="float32 or torch.float64"):
        f(*(v.half() for v in args))
    with pytest.raises(TypeError, match="a_u must be torch.float32"):
        f(*args[:2], args[2].double(), *args[3:])
    with pytest.raises(ValueError, match="shape"):
        f(args[0][0].contiguous(), *args[1:])
    with pytest.raises(ValueError, match="CUDA device"):
        f(*(v.cpu() for v in args))
    with pytest.raises(ValueError, match="shape"):
        f(*args[:2], args[2][:, :1], *args[3:])
    with pytest.raises(ValueError, match="shape"):
        f(*args[:8], args[8][:-1], *args[9:])
    with pytest.raises(ValueError, match=r"dU must be \(B, T, m\)"):
        f(args[0], args[1][0], *args[2:])
    strided = args[3].transpose(0, 1).contiguous().transpose(0, 1)
    with pytest.raises(ValueError, match="contiguous"):
        f(*args[:3], strided, *args[4:])
    assert f.launches == before
    f(*args)
    f(*args)
    assert f.launches == before + 2


@pytest.mark.gpu
def test_line_search_on_card_goes_through_l1(cuda_device):
    """``solve_fixed`` and ``solve`` (3 Newton steps, cyclic reduction)
    at N=16 on float32 CUDA data score each bank through L1, one launch a
    line search, and agree with the same calls on the CPU (plain
    version) within 1e-4 of the solution's scale; in float64 too, through
    L1's float64 instance, within 1e-10."""
    T = 16
    prob, op, *data = _l1_problem(T, 27, 64, cuda_device)
    f = newton_kkt.line_search_bank
    before = f.launches
    got = newton_kkt.solve_fixed(prob, op, *data, horizon=T).U
    got3 = newton_kkt.solve(prob, *data, horizon=T, n_newton=3).U
    torch.cuda.synchronize()
    assert f.launches == before + 4
    prob64, op64 = tree.cast(prob, torch.float64), tree.cast(op, torch.float64)
    data64 = [v.double() for v in data]
    got64 = newton_kkt.solve_fixed(prob64, op64, *data64, horizon=T).U
    assert f.launches == before + 5
    want64 = newton_kkt.solve_fixed(
        tree.cast(prob64, device="cpu"), tree.cast(op64, device="cpu"),
        *(v.cpu() for v in data64), horizon=T).U
    torch.testing.assert_close(got64.cpu(), want64, rtol=1e-10,
                               atol=1e-10 * float(want64.abs().max()))
    cpu = [v.cpu() for v in data]
    want = newton_kkt.solve_fixed(tree.cast(prob, device="cpu"),
                                  tree.cast(op, device="cpu"), *cpu,
                                  horizon=T).U
    want3 = newton_kkt.solve(tree.cast(prob, device="cpu"), *cpu, horizon=T,
                             n_newton=3).U
    for g, w in ((got, want), (got3, want3)):
        assert torch.isfinite(g).all()
        torch.testing.assert_close(g.cpu(), w, rtol=1e-4,
                                   atol=1e-4 * float(w.abs().max()))


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(4096, 4096), (1000, 1000), (3, 7)])
@pytest.mark.parametrize("kernel", ["b5a", "b5b"])
def test_b5_cuda_kernels_match_plain(cuda_device, kernel, shape):
    """Kernels B5a/B5b vs their plain versions on the card, at the peaks
    run's shape and at shapes no block size divides, k in {0, 1, 8, 32},
    on 0.7 and on U(-3, 3): atol 1e-6 (both chains contract)."""
    wrapper, plain, _ = CHAINS[kernel]
    rng = np.random.default_rng(4)
    for x in (torch.full(shape, 0.7, device=cuda_device),
              torch.as_tensor(rng.uniform(-3, 3, size=shape).astype(
                  np.float32), device=cuda_device)):
        for k in (0, 1, 8, 32):
            before = wrapper.launches
            got = wrapper(x, k)
            torch.cuda.synchronize()
            assert wrapper.launches == before + 1
            torch.testing.assert_close(got, plain(x, k), rtol=0, atol=1e-6)


@pytest.mark.gpu
def test_b5b_cos_link_sweeps_every_float32(cuda_device):
    """Kernel B5b at k = 1 on all 2^32 float32 bit patterns, in chunks of
    2^28 (device_peaks.cos_sweep): every finite input within 2 ulp of
    torch.cos of the float64 input; |v| >= 105615 and the infinities
    torch.cos's float32 cosf bit for bit; NaN and +-inf give NaN, +-0
    gives 1.  The plain torch.cos's largest error is printed beside."""
    got = device_peaks.cos_sweep()
    print(f"B5b sweep: max {got['max_ulp']:.4f} ulp at {got['max_ulp_at']!r}"
          f"; torch.cos float32 max {got['plain_max_ulp']:.4f} ulp")
    assert got["patterns"] == 1 << 32
    assert got["max_ulp"] <= 2.0
    for key in ("finite_misses", "big_mismatches", "nan_misses",
                "zero_misses"):
        assert got[key] == 0, (key, got)


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["b5a", "b5b"])
def test_b5_wrappers_raise_on_bad_input(cuda_device, kernel):
    """float64, 1-D, non-contiguous inputs and k < 0 are refused on the
    card, and nothing is launched."""
    wrapper, _, _ = CHAINS[kernel]
    x = torch.zeros((64, 96), device=cuda_device)
    before = wrapper.launches
    with pytest.raises(TypeError, match="float32"):
        wrapper(x.double(), 1)
    with pytest.raises(ValueError, match="rows, cols"):
        wrapper(x.reshape(-1), 1)
    with pytest.raises(ValueError, match="contiguous"):
        wrapper(x.t(), 1)
    with pytest.raises(ValueError, match="k must be >= 0"):
        wrapper(x, -1)
    assert wrapper.launches == before


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["b5a", "b5b"])
def test_b5_link_is_counted_from_the_built_sass(cuda_device, kernel):
    """The built library's SASS has a link loop link_instructions reads,
    over the 4 elements a thread carries (B5a: one range check each; B5b:
    one check of their max), no MUFU (full precision), and no more FP32
    or issued instructions per element and link than the built links'
    record (device_peaks.BUILT_LINK_INSTRUCTIONS: B5a's is its yardstick,
    19 / 32); B5b's own link issues fewer than the cosf yardstick's 26.5
    that its bound is computed from."""
    _, _, name = CHAINS[kernel]
    text = device_peaks.sass(name)
    assert "MUFU.SIN" not in text and "MUFU.COS" not in text
    got = device_peaks.link_instructions(text)
    recorded = device_peaks.BUILT_LINK_INSTRUCTIONS[name]
    assert got["elements"] == 4
    assert "MUFU" not in got["by_opcode"]
    assert 0 < got["fp32"] <= recorded["fp32"]
    assert got["fp32"] < got["issued"] <= recorded["issued"]
    if kernel == "b5b":
        assert got["issued"] < device_peaks.LINK_INSTRUCTIONS[name]["issued"]


@pytest.mark.gpu
@pytest.mark.parametrize("prior", [False, True])
def test_matmul_tf32_restores_the_tf32_setting(cuda_device, prior):
    """Only the TF32 measurement turns TF32 on, and it puts back the
    setting it found."""
    torch.backends.cuda.matmul.allow_tf32 = prior
    try:
        got = device_peaks.matmul_peak(torch.float32, tf32=True, n=256)
        assert torch.backends.cuda.matmul.allow_tf32 is prior
        assert got["tf32"] and got["tflops"] > 0
        device_peaks.matmul_peak(torch.float32, n=256)
        assert torch.backends.cuda.matmul.allow_tf32 is prior
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False


# ------------------------------------------- the strong-turbulence recipe

def _recipe(R, d, n_test, **estimator_kw):
    cfg = strong_turbulence(reference_config(resolution=R), d)
    return cfg.replace(
        estimator=dataclasses.replace(cfg.estimator, **estimator_kw),
        sim=dataclasses.replace(cfg.sim, n_train=300, n_valid=50,
                                n_test=n_test))


@pytest.fixture(scope="module")
def recipe_64():
    """The recipe at R=64, D/r0=10, built on the card; skips without
    one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _recipe(64, 10.0, 10)
    return cfg, pipeline.build(cfg, "cuda")


@pytest.mark.gpu
def test_linearize_and_full_gn_on_card_match_cpu(cuda_device, recipe_64):
    """linearize_at and two seeded mmse Gauss-Newton iterations on a batch
    of 3 on the card vs the same on the CPU (the card's operators copied
    there): y0 and J within 1e-4 of their scale (float32 sums of R^2
    terms in other orders), x within 1e-3 of ||x_true||.  Scenario 0,
    whose Gauss-Newton matrix is made not positive definite (a negative
    rank-one map_reg part along its weakest direction), gives NaN on the
    card too, and the tracking rule keeps its base estimate."""
    _, sys_ = recipe_64
    loop = sys_.loop
    cpu = tree.cast(loop, device="cpu")
    stack = cpu.state_stack
    nx = stack.shape[0]
    rng = np.random.default_rng(2)
    x_true = torch.as_tensor((rng.normal(size=(3, nx)) * 0.3).astype(
        np.float32))
    x_true[0] = 0.0
    ph = (x_true @ stack.reshape(nx, -1)).reshape(3, 64, 64)
    y0, J = estimator.linearize_at(loop.est, ph.to(cuda_device),
                                   loop.state_stack)
    y0_ref, J_ref = estimator.linearize_at(cpu.est, ph, stack)
    for got, want in ((y0, y0_ref), (J, J_ref)):
        torch.testing.assert_close(got.cpu(), want, rtol=0,
                                   atol=1e-4 * float(want.abs().max()))
    y = estimator.measure(cpu.est, ph) + 0.05 * float(
        cpu.est.noise_std) * torch.as_tensor(rng.standard_normal(
            (3, cpu.est.n_pixels)).astype(np.float32))
    seed = x_true + 0.05 * torch.as_tensor(rng.normal(size=(3, nx)).astype(
        np.float32))
    got = estimator.estimate_full_gn(loop.est, y.to(cuda_device),
                                     loop.state_stack, 2,
                                     x_init=seed.to(cuda_device))
    want = estimator.estimate_full_gn(cpu.est, y, stack, 2, x_init=seed)
    for i in range(3):
        torch.testing.assert_close(
            got[i].cpu(), want[i], rtol=0,
            atol=1e-3 * max(float(x_true[i].norm()), 1.0))

    lam = 1e-3 * float(torch.trace(cpu.est.A_s.T @ cpu.est.A_s)) / nx
    J64 = J_ref.double()
    H = (J64.transpose(1, 2) @ J64 + lam * torch.eye(nx, dtype=torch.float64)
         + cpu.est.map_reg.double())
    v = torch.linalg.eigh(H[0])[1][:, 0]
    thresh = [1.0 / float(v @ torch.linalg.solve(Hi, v)) for Hi in H]
    assert thresh[0] * 1.5 < min(thresh[1:]), thresh
    c = (thresh[0] * min(thresh[1:])) ** 0.5
    bad_reg = (cpu.est.map_reg - c * torch.outer(v, v).float())
    bad = dataclasses.replace(loop.est, map_reg=bad_reg.to(cuda_device))
    x0 = estimator.estimate(loop.est, y.to(cuda_device))
    x_gn = estimator.estimate_full_gn(bad, y.to(cuda_device),
                                      loop.state_stack, 1,
                                      x_init=x_true.to(cuda_device))
    assert torch.isnan(x_gn[0]).all() and torch.isfinite(x_gn[1:]).all()
    sig2 = torch.full((3,), float(cpu.est.noise_std) ** 2,
                      device=cuda_device)
    x = closed_loop.track_estimate(dataclasses.replace(loop, est=bad),
                                   y.to(cuda_device), x0,
                                   x_true.to(cuda_device), sig2, 1)
    assert torch.equal(x[0], x0[0]) and torch.isfinite(x).all()


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["warm_start", "tracking_fusion"])
def test_recipe_loop_on_card_matches_cpu(cuda_device, recipe_64, case):
    """The recipe loop at B=4 from its warm start, 10 steps with injected
    noise, on the card (B1) and on the CPU (plain versions, the same
    operators): residual RMS rtol 0.01 / atol 5e-3, u atol 0.02 max|u|;
    also with the tracking estimator and the estimator-VAR fusion (est_gain
    0.9, innovation_gate 5), where B1 runs 4 times a step."""
    cfg, sys_ = recipe_64
    if case == "tracking_fusion":
        cfg = cfg.replace(
            estimator=dataclasses.replace(cfg.estimator, track_gn_iters=1),
            mpc=dataclasses.replace(cfg.mpc, est_gain=0.9,
                                    innovation_gate=5.0))
    n_steps, B = 10, 4
    start = cfg.sim.n_train + cfg.sim.n_valid
    init_u = pipeline.warm_start_command(sys_, cfg, start)
    rng = np.random.default_rng(5)
    noise = torch.as_tensor((float(sys_.est.noise_std) * rng.standard_normal(
        (B, n_steps, sys_.est.n_pixels))).astype(np.float32))
    b1 = psf_kernels.psf_crop_diversity_sym3
    before = b1.launches
    kw = dict(n_steps=n_steps, start_step=start)
    got = closed_loop.simulate(sys_.loop, sys_.layers, cfg, None,
                               noise_seq=noise.to(cuda_device),
                               init_u=init_u, **kw)
    torch.cuda.synchronize()
    assert b1.launches - before == n_steps * (
        4 if case == "tracking_fusion" else 2)
    want = closed_loop.simulate(
        tree.cast(sys_.loop, device="cpu"),
        tree.cast(sys_.layers, device="cpu"), cfg, None, noise_seq=noise,
        init_u=init_u.cpu(), **kw)
    for field in got:
        assert torch.isfinite(field).all()
    torch.testing.assert_close(got.rms_res.cpu(), want.rms_res, rtol=0.01,
                               atol=5e-3)
    torch.testing.assert_close(got.u.cpu(), want.u, rtol=0,
                               atol=0.02 * float(want.u.abs().max()))


@pytest.mark.gpu
def test_d_over_r0_15_closes_with_shrunk_prior(cuda_device):
    """The JAX package's test of the same name (tests/test_configs.py) on
    the card: the recipe with prior_scale 0.05 at D/r0=15, R=128, 60
    steps from the warm start holds the lock -- residual below 1 rad at
    every step, settled residual below 0.35x the turbulence and settled
    exact Strehl above 0.85."""
    cfg = _recipe(128, 15.0, 60, prior_scale=0.05)
    sys_ = pipeline.build(cfg, cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    out = pipeline.run_closed_loop(sys_, cfg, gen)
    res, turb = out.rms_res.cpu(), out.rms_turb.cpu()
    assert float(res.max()) < 1.0
    assert float(res[30:].mean()) < 0.35 * float(turb[30:].mean())
    assert float(out.strehl_exact[30:].mean()) > 0.85


# ------------------------------------------------- the general MPC solvers

def _solver_problem(rng, T, B=4, n=3, m=2):
    """A small VAR(2) problem (box 2, ramp 0.4) with per-scenario x0,
    x0_pre, w and u_prev, on the CPU."""
    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32))
    prob = solvers.make_fastmpc_problem(
        t(0.5 * np.eye(n) + 0.1 * rng.normal(size=(n, n))),
        t(0.15 * np.eye(n) + 0.05 * rng.normal(size=(n, n))),
        t(rng.normal(size=(n, m))), q_weight=10.0, p_weight=10.0,
        r_weight=1.0, u_max=2.0, barrier_k=1e-2, du_max=0.4)
    prob = dataclasses.replace(prob, u_prev=t(rng.uniform(-1.5, 1.5,
                                                          (B, m))))
    return prob, (t(rng.normal(size=(B, n)) * 0.5),
                  t(rng.normal(size=(B, n)) * 0.5),
                  t(rng.normal(size=(B, T * n)) * 0.3))


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["dense", "cyclic_reduction", "ramp",
                                  "admm"])
def test_general_solvers_on_card_match_cpu(cuda_device, case):
    """newton_kkt.solve (8 Newton steps: dense Schur at T=3, cyclic
    reduction at T=20, ramp rows at T=3) and admm_condensed (400
    iterations, two adaptive-rho rounds, per-scenario ramp bounds) on the
    card vs the same call on the CPU: within 1e-4 of the solution's
    scale (float32 sums in other orders)."""
    rng = np.random.default_rng(11)
    if case == "admm":
        nx, nu, N = 4, 3, 3
        t = dict(dtype=torch.float32)
        mats = mpc.design_matrices(
            torch.eye(nx, **t) * 0.5, torch.eye(nx, **t) * 0.1,
            torch.as_tensor(rng.normal(size=(nx, nu)), **t), N,
            10 * torch.eye(nx, **t), 10 * torch.eye(nx, **t),
            torch.eye(nu, **t))
        r = torch.as_tensor(rng.normal(size=(4, N * nu)) * 10, **t)
        lo = torch.full((N * nu,), -0.8)
        dlo = torch.full((4, N * nu), -0.3)
        dlo[:, :nu] += torch.as_tensor(rng.uniform(-0.5, 0.5, (4, nu)), **t)
        args = (r, lo, -lo, dlo, dlo + 0.6)
        kw = dict(adapt_rounds=2)
        want = solvers.admm_condensed(mats, *args, **kw)
        got = solvers.admm_condensed(
            tree.cast(mats, device=cuda_device),
            *(a.to(cuda_device) for a in args), **kw)
    else:
        T = 20 if case == "cyclic_reduction" else 3
        prob, args = _solver_problem(rng, T)
        ramp = case == "ramp"
        want = newton_kkt.solve(prob, *args, horizon=T, n_newton=8,
                                ramp=ramp).U
        got = newton_kkt.solve(tree.cast(prob, device=cuda_device),
                               *(a.to(cuda_device) for a in args),
                               horizon=T, n_newton=8, ramp=ramp).U
    assert got.is_cuda and torch.isfinite(got).all()
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4,
                               atol=1e-4 * float(want.abs().max()))


@pytest.fixture(scope="module")
def bench_64():
    """reference_config(64) cut to 300 + 50 identification steps, built on
    the card; skips without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = reference_config(resolution=64)
    cfg = cfg.replace(sim=dataclasses.replace(cfg.sim, n_train=300,
                                              n_valid=50))
    return cfg, pipeline.build(cfg, "cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("solver,newton_steps,horizon", [
    ("admm", 1, 2), ("fastmpc_ramp", 1, 2), ("fastmpc", 2, 2),
    ("fastmpc", 2, 16)])
def test_solver_loop_on_card_matches_cpu(cuda_device, bench_64, solver,
                                         newton_steps, horizon):
    """The loop at B=4, 10 steps with injected noise, through each new
    branch of the solver switch (ADMM, the ramp rows, the general Newton
    solve; at N=16 through with_horizon, where it runs cyclic reduction),
    on the card (B1 twice a step: the measure and one Gauss-Newton pass)
    and on the CPU (plain versions, the same
    operators): residual RMS rtol 0.01 / atol 5e-3, u atol 0.02 max|u|."""
    cfg, sys_ = bench_64
    cfg = cfg.replace(mpc=dataclasses.replace(
        cfg.mpc, solver=solver, newton_steps=newton_steps, horizon=horizon))
    if horizon != 2:
        sys_ = pipeline.with_horizon(sys_, cfg)
    n_steps, B = 10, 4
    rng = np.random.default_rng(5)
    noise = torch.as_tensor((float(sys_.est.noise_std) * rng.standard_normal(
        (B, n_steps, sys_.est.n_pixels))).astype(np.float32))
    b1 = psf_kernels.psf_crop_diversity_sym3
    before = b1.launches
    kw = dict(n_steps=n_steps, start_step=cfg.sim.n_train + cfg.sim.n_valid,
              mag=torch.linspace(1.0, 1.8, B))
    got = closed_loop.simulate(sys_.loop, sys_.layers, cfg, None,
                               noise_seq=noise.to(cuda_device), **kw)
    torch.cuda.synchronize()
    assert b1.launches - before == n_steps * (
        1 + cfg.estimator.gauss_newton_iters)
    want = closed_loop.simulate(
        tree.cast(sys_.loop, device="cpu"),
        tree.cast(sys_.layers, device="cpu"), cfg, None, noise_seq=noise,
        **kw)
    for field in got:
        assert torch.isfinite(field).all()
    torch.testing.assert_close(got.rms_res.cpu(), want.rms_res, rtol=0.01,
                               atol=5e-3)
    torch.testing.assert_close(got.u.cpu(), want.u, rtol=0,
                               atol=0.02 * float(want.u.abs().max()))


@pytest.fixture(scope="module")
def edge_64():
    """reference_config(64) on the conditional flow, cut to 300 + 50
    identification steps, built by pipeline.build with no device named
    (so on the card); skips without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = reference_config(resolution=64)
    cfg = cfg.replace(
        atmosphere=dataclasses.replace(cfg.atmosphere, flow="conditional"),
        sim=dataclasses.replace(cfg.sim, n_train=300, n_valid=50))
    return cfg, pipeline.build(cfg)


@pytest.mark.gpu
def test_conditional_build_defaults_to_the_card(cuda_device, edge_64):
    """pipeline.build on a conditional config with no device builds on
    the card: the flow's operators, its state at the test split and the
    identification series, all finite."""
    _, sys_ = edge_64
    for t in (sys_.edge_model.A, sys_.edge_model.Bc,
              sys_.edge_model.inner_idx, sys_.edge_state.phases,
              sys_.coeff_series, sys_.loop.influence):
        assert t.is_cuda
    assert torch.isfinite(sys_.coeff_series).all()
    assert torch.isfinite(sys_.edge_state.phases).all()


@pytest.mark.gpu
@pytest.mark.parametrize("per_scenario", [False, True])
def test_conditional_loop_on_card_matches_cpu(cuda_device, edge_64,
                                              per_scenario):
    """The conditional-flow loop at B=4, 10 steps, with injected noise and
    injected border normals, on the card (B1 twice a step: the measure
    and one Gauss-Newton pass) and on the CPU
    (plain versions, the same operators and state): one shared flow, and
    one flow per scenario from the same state; residual RMS rtol 0.01 /
    atol 5e-3, u atol 0.02 max|u|."""
    cfg, sys_ = edge_64
    n_steps, B = 10, 4
    model = sys_.edge_model
    rng = np.random.default_rng(5)
    noise = torch.as_tensor((float(sys_.est.noise_std) * rng.standard_normal(
        (B, n_steps, sys_.est.n_pixels))).astype(np.float32))
    lead = (B,) if per_scenario else ()
    eps = torch.as_tensor(rng.standard_normal(
        (*lead, n_steps, model.k_max + 1, model.n_layers, model.n_border)
    ).astype(np.float32))
    b1 = psf_kernels.psf_crop_diversity_sym3
    before = b1.launches
    start = cfg.sim.n_train + cfg.sim.n_valid
    kw = dict(n_steps=n_steps, mag=torch.linspace(1.0, 1.8, B))
    if per_scenario:
        kw["start_step"] = torch.full((B,), float(start))
    else:
        kw["start_step"] = start
    got = closed_loop.simulate(sys_.loop, None, cfg, None,
                               noise_seq=noise.to(cuda_device),
                               edge_model=model, edge_state=sys_.edge_state,
                               edge_eps=eps.to(cuda_device), **kw)
    torch.cuda.synchronize()
    assert b1.launches - before == n_steps * (
        1 + cfg.estimator.gauss_newton_iters)
    want = closed_loop.simulate(
        tree.cast(sys_.loop, device="cpu"), None, cfg, None,
        noise_seq=noise, edge_model=tree.cast(model, device="cpu"),
        edge_state=tree.cast(sys_.edge_state, device="cpu"), edge_eps=eps,
        **{k: v.cpu() if isinstance(v, torch.Tensor) else v
           for k, v in kw.items()})
    for field in got:
        assert torch.isfinite(field).all()
    torch.testing.assert_close(got.rms_res.cpu(), want.rms_res, rtol=0.01,
                               atol=5e-3)
    torch.testing.assert_close(got.u.cpu(), want.u, rtol=0,
                               atol=0.02 * float(want.u.abs().max()))


@pytest.mark.gpu
def test_bf16_border_draw_on_card_matches_cpu(cuda_device):
    """edge_op_dtype="bfloat16" at R=128: the card's border draw (a bf16
    product with float32 output) vs the CPU's (the float32 upcast of the
    same bf16 values) on the same phases and normals, one state per
    scenario (B=3): within 1e-5 of the draw's scale (float32
    accumulation order only)."""
    cfg = reference_config(resolution=128)
    tel = dataclasses.replace(cfg.telescope, resolution=128)
    model, _ = edge_flow.build(0, cfg.atmosphere, tel, op_dtype="bfloat16",
                               device=cuda_device)
    states = edge_flow.batch_states(1, cfg.atmosphere, tel, 3,
                                    device=cuda_device)
    eps = torch.randn((3, model.n_layers, model.n_border),
                      generator=torch.Generator().manual_seed(0))
    got = edge_flow._draw_borders(model, states.phases, eps.to(cuda_device))
    want = edge_flow._draw_borders(tree.cast(model, device="cpu"),
                                   states.phases.cpu(), eps)
    assert got.dtype == torch.float32
    torch.testing.assert_close(got.cpu(), want, rtol=0,
                               atol=1e-5 * float(want.abs().max()))


def _parallel_system(dev):
    cfg = reference_config(resolution=64)
    cfg = cfg.replace(sim=dataclasses.replace(cfg.sim, n_train=300,
                                              n_valid=50, n_test=10))
    return cfg, pipeline.build(cfg, dev)


@pytest.mark.gpu
def test_sharded_stats_under_nccl_match_run_batch(cuda_device, tmp_path):
    """A world of one rank under NCCL on the card: run_sharded over 64
    shared-window scenarios, 10 steps, equals run_batch's reduction of
    the same batch within rtol 1e-4 (tests/test_parallel.py), and a NaN
    magnification is counted in n_diverged and kept out of the means."""
    import torch.distributed as dist

    from mpc_sensorlessao_tpu_torch.benchmarks import multiprocess
    from mpc_sensorlessao_tpu_torch.parallel import mesh, montecarlo
    from mpc_sensorlessao_tpu_torch.parallel import multihost

    cfg, system = _parallel_system(cuda_device)
    scen = montecarlo.make_scenarios(cfg, torch.Generator().manual_seed(1),
                                     64, d_over_r0_grid=(5.0, 10.0),
                                     snr_db_grid=(5.0, 10.0),
                                     device=cuda_device)
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0,
                            timeout=multihost.TIMEOUT)
    try:
        runner = montecarlo.make_sharded_runner(
            system.loop, system.layers, cfg, 10,
            mesh.scenario_mesh(device_type="cuda"), shared_window=True)
        stats = runner(scen).as_floats()
        mag = scen.mag.clone()
        mag[3] = float("nan")
        bad = runner(scen._replace(mag=mag)).as_floats()
    finally:
        dist.destroy_process_group()
    one = montecarlo.reduce_stats(montecarlo.run_batch(
        system.loop, system.layers, cfg, scen, 10, shared_window=True), 10)
    assert multiprocess.max_rel_delta(stats, one.as_floats()) <= 1e-4
    assert stats["n_scenarios"] == 64
    assert bad["n_diverged"] >= 1
    assert bad["n_scenarios"] + bad["n_diverged"] == 64
    assert np.isfinite(bad["mean_rms_res"]) and bad["mean_rms_res"] < 10.0


@pytest.mark.gpu
def test_two_gloo_ranks_on_one_card_match_one_process(cuda_device,
                                                      tmp_path):
    """Two spawned ranks sharing cuda:0 over gloo (NCCL refuses two ranks
    on one device), each restoring the system from a checkpoint: their
    run_sharded statistics over 64 scenarios equal rank 0's one-process
    run_batch of the same scenarios within rtol 1e-4, and each rank ran
    B1 once a step and once more a Gauss-Newton pass."""
    from mpc_sensorlessao_tpu_torch.benchmarks import multiprocess
    from mpc_sensorlessao_tpu_torch.parallel import multihost

    cfg, system = _parallel_system(cuda_device)
    psf_kernels.psf_crop_diversity_sym3(*_b1_args(64, 1, 15, cuda_device))
    system_dir = str(tmp_path / "system")
    multiprocess.save_system(system_dir, system, cfg)
    job = {"system_dir": system_dir, "n_scenarios": 64, "n_steps": 10,
           "d_grid": (5.0, 10.0), "snr_grid": (5.0, 10.0), "seed": 1,
           "reference": True}
    ranks = multihost.spawn(multiprocess.sharded_stats, 2, backend="gloo",
                            device="cuda:0", args=(job,), timeout=600.0)
    assert ranks[0]["max_rel_delta"] <= 1e-4
    assert ranks[0]["stats"] == ranks[1]["stats"]
    per_step = 1 + cfg.estimator.gauss_newton_iters
    assert [r["launches"] for r in ranks] == [10 * per_step] * 2


@pytest.mark.gpu
def test_population_resumes_bit_identically_on_card(cuda_device, tmp_path):
    """benchmarks/montecarlo_100k.py on the card at R=64 (2 SNRs x 8
    reps, 2 chunks, 20 steps): stopped after one chunk and resumed, the
    summaries are bit-identical to the uninterrupted run's."""
    from mpc_sensorlessao_tpu_torch.benchmarks import montecarlo_100k

    env = {"MC1_DEVICE": "cuda", "MC1_DR0": "5", "MC1_SNR": "10,20",
           "MC1_REPS": "8", "MC1_CHUNK": "4", "MC1_STEPS": "20"}
    full = montecarlo_100k.main(["64"], dict(env,
                                             MC1_CKPT=str(tmp_path / "a")))
    env_b = dict(env, MC1_CKPT=str(tmp_path / "b"))
    with pytest.raises(SystemExit) as stop:
        montecarlo_100k.main(["64"], dict(env_b, MC1_STOP_AFTER="1"))
    assert stop.value.code == montecarlo_100k.STOPPED
    resumed = montecarlo_100k.main(["64", "--resume"], env_b)
    assert resumed["resumed_at_cursor"] == 1
    assert np.isfinite(full["summaries"]).all()
    np.testing.assert_array_equal(resumed["summaries"], full["summaries"])


# ------------------------------------------------ sensing on the card

def _screen(R, dev, scale=0.3, seed=3):
    from mpc_sensorlessao_tpu_torch.ops import phase_screens
    cfg = reference_config(resolution=R)
    scr = phase_screens.synthesize_screen(
        seed, cfg.atmosphere.layer(0), R, cfg.telescope.pixel_pitch)[:R, :R]
    return torch.as_tensor((scr - scr.mean()) * scale, device=dev)


def _peak_close(got, want, frac=1e-4):
    got, want = got.cpu().numpy(), want.cpu().numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=frac * np.abs(want).max())


@pytest.mark.gpu
def test_sh_slopes_on_card_match_cpu(cuda_device):
    """At R=128 with 8 lenslets (the classical comparison's geometry):
    geometric, diffractive and noise-free camera slopes (thresholded,
    reference subtracted) on the card within 1e-4 of their peak of the
    CPU's, on a batch of two screens."""
    from mpc_sensorlessao_tpu_torch.models import wfs
    R = 128
    ph = torch.stack([_screen(R, "cpu", seed=s) for s in (3, 4)])
    out = {}
    for dev in ("cpu", cuda_device):
        sh = wfs.build(R, n_lenslet=8, device=dev)
        x = ph.to(dev)
        ref = wfs.reference_slopes(sh)
        out[str(dev)] = [
            wfs.geometric_slopes(sh, x), wfs.diffractive_slopes(sh, x),
            wfs.camera_slopes(sh, x, None, threshold=(0.01, 0.1),
                              ref_slopes=ref),
            wfs.interaction_matrix(sh, zernike.make_basis(
                4, R, device=dev).stack[1:])]
    for got, want in zip(out[str(cuda_device)], out["cpu"]):
        _peak_close(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("modulation", [0.0, 3.0])
def test_pyramid_slopes_on_card_match_cpu(cuda_device, modulation):
    """At R=64, 16 lenslets: detector image and slopes on the card (one
    batched cuFFT pair over the modulation steps) within 1e-4 of their
    peak of the CPU's; the gain calibration agrees within 1e-4."""
    from mpc_sensorlessao_tpu_torch.models import pyramid
    R = 64
    ph = _screen(R, "cpu", scale=0.2)
    tilt = zernike.make_basis(2, R, device="cpu").stack[1]
    res = {}
    for dev in ("cpu", cuda_device):
        m = pyramid.build(R, 16, modulation=modulation, device=dev)
        cal = pyramid.gain_calibration(m, tilt.to(dev))
        res[str(dev)] = (pyramid.intensity_map(m, ph.to(dev)),
                         pyramid.slopes(m, ph.to(dev)), cal.slopes_units)
    card, cpu = res[str(cuda_device)], res["cpu"]
    _peak_close(card[0], cpu[0])
    _peak_close(card[1], cpu[1])
    assert card[2] == pytest.approx(cpu[2], rel=1e-4)


@pytest.mark.gpu
def test_integrator_on_card_matches_cpu(cuda_device):
    """The classical comparison's SH + TSVD integrator at R=64 on a
    50-step window with one injected slope-noise tensor: c_acc and rms on
    the card within rtol 1e-4 of the CPU's, at each gain and a delay."""
    from mpc_sensorlessao_tpu_torch.benchmarks import classical_vs_mpc as cvm
    from mpc_sensorlessao_tpu_torch.models import integrator
    cfg = cvm.row_cfg(64, 5.0, 50)
    cfg = cfg.replace(sim=dataclasses.replace(cfg.sim, n_train=300,
                                              n_valid=50))
    system = pipeline.build(cfg, "cpu")
    sh, stack, vault = cvm.classical_setup(system, cfg)
    flat = cvm.turbulence_window(system, cfg, 50)
    noise = 0.02 * torch.randn((50, sh.n_slopes),
                               generator=torch.Generator().manual_seed(2))
    mask = system.loop.mask.reshape(-1)
    dev_vault = dataclasses.replace(vault, M=vault.M.to(cuda_device))
    for icfg in (integrator.IntegratorConfig(0.7),
                 integrator.IntegratorConfig(0.5, delay=2)):
        want = integrator.closed_loop(sh.slope_op, vault, stack, flat, icfg,
                                      mask_flat=mask, slope_noise=noise)
        got = integrator.closed_loop(
            sh.slope_op.to(cuda_device), dev_vault, stack.to(cuda_device),
            flat.to(cuda_device), icfg, mask_flat=mask.to(cuda_device),
            slope_noise=noise.to(cuda_device))
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.cpu().numpy(), w.numpy(),
                                       rtol=1e-4,
                                       atol=1e-4 * float(w.abs().max()))


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["photon", "qe", "readout"])
def test_read_out_noise_law_on_card(cuda_device, case):
    """imaging.read_out drawn from a cuda generator meets
    tests/test_imaging.py's criteria: Poisson mean = var = flux, QE after
    the draw (var = QE^2 flux), readout std."""
    from mpc_sensorlessao_tpu_torch.models import imaging
    det, flux, mean, var = {
        "photon": (imaging.DetectorConfig(64, photon_noise=True), 50.0,
                   50.0, 50.0),
        "qe": (imaging.DetectorConfig(64, photon_noise=True,
                                      quantum_efficiency=0.5), 100.0, 50.0,
               25.0),
        "readout": (imaging.DetectorConfig(64, read_out_noise=3.0), 0.0,
                    0.0, 9.0)}[case]
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(1)
    out = imaging.read_out(det, gen, torch.full((64, 64), flux,
                                                device=cuda_device))
    assert out.device.type == "cuda" and out.dtype == torch.float32
    out = out.cpu().numpy()
    assert out.mean() == pytest.approx(mean, rel=0.02, abs=0.15)
    assert out.var() == pytest.approx(var, rel=0.1)


@pytest.mark.gpu
def test_classical_row_on_card(cuda_device):
    """benchmarks/classical_vs_mpc.row on the card at R=64, 16 steps (cut
    sim): B1 launches exactly 16 x (1 + gauss_newton_iters) in the MPC
    loop and none in the build, and the ideal integrator rows equal the
    CPU row's within rtol 1e-4 (the same window; the MPC's noise stream
    differs between the devices)."""
    from mpc_sensorlessao_tpu_torch.benchmarks import classical_vs_mpc as cvm
    cfg = cvm.row_cfg(64, 5.0, 16)
    cfg = cfg.replace(sim=dataclasses.replace(cfg.sim, n_train=300,
                                              n_valid=50))
    card = cvm.row(cfg, cuda_device)
    cpu = cvm.row(cfg, "cpu")
    assert card["b1_launches_build"] == 0
    assert card["mpc"]["b1_launches"] == 16 * (
        1 + cfg.estimator.gauss_newton_iters)
    np.testing.assert_allclose(
        [r["mean_rms_res"] for r in card["runs"]["integrator"]],
        [r["mean_rms_res"] for r in cpu["runs"]["integrator"]], rtol=1e-4)
    assert card["mpc"]["strehl_exact"] > 0.9


# ------------------------------------------- ROADMAP A.12: the MCAO slice

def _a12_problem(kind, dev, sigma_px, n=4):
    """The wfs demo's problem (10x10 SH at R=80) for the NGS, 3-GS
    tomographic (8 km layer, 10" triangle) or H=20 km LGS reconstructor
    on ``dev``, and n frames of numpy-seeded screens, each seen as that
    system sees it (projected into each guide star's direction, or onto
    the LGS cone)."""
    from mpc_sensorlessao_tpu_torch.models import slopes_mmse, wfs
    from mpc_sensorlessao_tpu_torch.ops import phase_screens, relay
    from mpc_sensorlessao_tpu_torch.utils.config import AtmosphereConfig
    R, NL, pitch = 80, 10, 1.0 / 79
    alt = 0.0 if kind == "ngs" else 8000.0
    atm = AtmosphereConfig(fractional_r0=(1.0,), altitudes=(alt,),
                           wind_speeds=(5.0,), wind_directions=(0.0,))
    sh = wfs.build(R, NL, device="cpu")
    nv = (sigma_px / pitch) ** 2
    th = 10 * np.pi / 180 / 3600
    gs = [(th, 0.0), (-th / 2, th * 0.866), (-th / 2, -th * 0.866)]
    scr = torch.as_tensor(np.stack([phase_screens.synthesize_screen(
        s, atm, 192, pitch, oversample=1) * 0.3 for s in range(7, 7 + n)]))

    def seen(**kw):
        return wfs.geometric_slopes(sh, relay.project_layers(
            [scr], [pitch], 0.5, atm.altitudes, R, **kw))
    if kind == "tomo":
        sl = torch.stack([seen(direction=g) for g in gs], dim=1)
    else:
        sl = seen(source_height=20e3 if kind == "lgs" else float("inf"))

    def build(d):
        if kind == "ngs":
            return slopes_mmse.build(atm, 1.0, NL, sh.valid, nv, device=d)
        if kind == "tomo":
            return slopes_mmse.build_tomographic(atm, 1.0, NL, sh.valid, nv,
                                                 gs, device=d)
        return slopes_mmse.build_lgs(atm, 1.0, NL, sh.valid, nv, 20e3,
                                     device=d)
    rec = {"ngs": slopes_mmse.reconstruct,
           "tomo": slopes_mmse.reconstruct_tomographic,
           "lgs": slopes_mmse.reconstruct_lgs}[kind]
    return build(dev), build("cpu"), sl, rec, pitch


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["ngs", "tomo", "lgs"])
def test_slopes_mmse_cg_on_card_matches_cpu(cuda_device, kind):
    """The batched CG on the card against the CPU: at a fixed depth of 4
    iterations and on a well-conditioned batch (0.3 px noise) the maps
    within 1e-4 of their RMS and the same iteration counts (depth 6 read
    1.1e-4 on the tomographic problem: rounding grows ~6x an iteration);
    at the demo's 0.02 px and tol 5e-2, where the float32 CG is not
    reproducible (depths 3 apart in 63 were read), the map RMS within 5%,
    the depth within 10% (or 2 iterations) and each card answer a
    solution of the CPU's system to 1.2 x tol in float64."""
    from mpc_sensorlessao_tpu_torch.models import slopes_mmse
    maxit = 150 if kind == "tomo" else 100
    for sigma, kw in ((0.02, dict(tol=0.0, maxit=4)),
                      (0.3, dict(tol=5e-2, maxit=maxit)),
                      (0.02, dict(tol=5e-2, maxit=maxit))):
        card, cpu, sl, rec, pitch = _a12_problem(kind, cuda_device, sigma)
        got = rec(card, sl.to(cuda_device), pitch, **kw)
        want = rec(cpu, sl, pitch, **kw)
        y, it = slopes_mmse.solve(card, sl.to(cuda_device), pitch, **kw)
        want_it = slopes_mmse.solve(cpu, sl, pitch, **kw)[1]
        rms = want.pow(2).mean(dim=(-2, -1)).sqrt()
        err = (got.cpu() - want).abs().amax(dim=(-2, -1))
        if kw["tol"] == 0.0 or sigma == 0.3:
            assert torch.equal(it.cpu(), want_it)
            assert (err <= 1e-4 * rms).all(), err / rms
        else:
            assert ((it.cpu() - want_it).abs()
                    <= torch.clamp(0.1 * want_it, min=2)).all()
            torch.testing.assert_close(got.std(dim=(-2, -1)).cpu(),
                                       want.std(dim=(-2, -1)), rtol=0.05,
                                       atol=0)
            res = slopes_mmse.relative_residual(cpu, sl, pitch, y.cpu())
            assert (res <= 1.2 * 5e-2).all(), res


@pytest.mark.gpu
def test_relay_lgs_and_raytrace_on_card_match_cpu(cuda_device):
    """project_layers (off-axis, LGS cone) on a batch of screens,
    elongate_spots with an even and an odd kernel width, and trace on
    1e5 rays: card against CPU, atol 1e-5 of the peak."""
    from mpc_sensorlessao_tpu_torch.models import lgs, wfs
    from mpc_sensorlessao_tpu_torch.ops import raytrace, relay
    rng = np.random.default_rng(0)
    scr = [torch.as_tensor(rng.normal(size=(4, n, n)), dtype=torch.float32)
           for n in (192, 160)]
    for kw in (dict(direction=(5e-5, -2e-5)),
               dict(direction=(2e-5, 0.0), source_height=90e3)):
        want = relay.project_layers(scr, [1 / 47, 1 / 40], 0.5,
                                    (0.0, 8000.0), 48, **kw)
        got = relay.project_layers([s.to(cuda_device) for s in scr],
                                   [1 / 47, 1 / 40], 0.5, (0.0, 8000.0), 48,
                                   **kw)
        torch.testing.assert_close(got.cpu(), want, rtol=0,
                                   atol=1e-5 * float(want.abs().max()))
    heights = 1e3 * (np.arange(-5, 6) + 90.0)
    pos = lgs.subaperture_positions(10, 1.0)
    sh = wfs.build(80, 10, device="cpu")
    spots = wfs.spot_frames(sh, torch.as_tensor(
        rng.normal(0, 0.5, (2, 80, 80)), dtype=torch.float32))
    for kw_px in (8, 9):
        ker = [lgs.elongation_kernels(lgs.build(heights, launch=(-0.5, 0.0),
                                                device=d), pos, 2e-7, kw_px,
                                      1.5) for d in ("cpu", cuda_device)]
        torch.testing.assert_close(ker[1].cpu(), ker[0], rtol=0, atol=1e-6)
        want = lgs.elongate_spots(spots, ker[0])
        got = lgs.elongate_spots(spots.to(cuda_device), ker[1])
        torch.testing.assert_close(got.cpu(), want, rtol=0,
                                   atol=1e-5 * float(want.abs().max()))
    chain = [raytrace.free_space(0.3, stop_width=0.08),
             raytrace.curved_mirror(1.0, offset=0.002, stop_width=0.05),
             raytrace.thin_lens(0.2)]
    rays = torch.as_tensor(rng.normal(0, [0.02, 0.01], (100_000, 2)),
                           dtype=torch.float32)
    want = raytrace.trace(chain, rays)
    got = raytrace.trace(chain, rays.to(cuda_device))
    torch.testing.assert_close(got[0].cpu(), want[0], rtol=1e-6, atol=1e-7)
    assert torch.equal(got[1].cpu(), want[1]) and got[2:] == want[2:]


@pytest.mark.gpu
def test_mcao_monte_carlo_on_card_matches_cpu(cuda_device):
    """The MCAO demo's batched Monte-Carlo (relay -> piston removal ->
    fit -> correct -> correction_coeffs) over 8 screen pairs: card
    against CPU, rtol 1e-4."""
    from mpc_sensorlessao_tpu_torch.examples import mcao_demo
    from mpc_sensorlessao_tpu_torch.models import mcao
    from mpc_sensorlessao_tpu_torch.utils.config import AtmosphereConfig
    atm = AtmosphereConfig(fractional_r0=(0.6, 0.4), altitudes=(0.0, 8000.0),
                           wind_speeds=(5.0, 5.0), wind_directions=(0.0, 0.0))
    th = 10 * np.pi / 180 / 3600
    gs = [(th, 0.0), (-th / 2, th * 0.866), (-th / 2, -th * 0.866)]
    sci = [(0.0, 0.0), (th, 0.0)]
    dms = [mcao.DMLayer(0.0, 3), mcao.DMLayer(8000.0, 3, skip_modes=3)]
    out = {}
    for d in (cuda_device, "cpu"):
        m = mcao.build(atm, 1.0, 4 * th, dms, 3, gs, sci, device=d)
        out[str(d)] = mcao_demo.monte_carlo(m, atm, sci + gs, 2, 3, 8, d)
    np.testing.assert_allclose(out[str(cuda_device)], out["cpu"], rtol=1e-4)


@pytest.mark.gpu
def test_a12_demos_on_card_match_the_jax_record(cuda_device):
    """wfs_demo and mcao_demo on the card against the JAX demos' numbers
    (examples/demo_reference.json), at tests/test_torch_demos.py's
    tolerances (map RMS 1%)."""
    import json
    from pathlib import Path
    from mpc_sensorlessao_tpu_torch.examples import mcao_demo, wfs_demo
    ref = json.loads((Path(wfs_demo.__file__).parent
                      / "demo_reference.json").read_text())
    w = wfs_demo.main(cuda_device)
    assert w["tomography_error_rad2"] == pytest.approx(
        ref["wfs"]["tomography_error_rad2"], rel=1e-6)
    assert w["mmse_rms"] == pytest.approx(ref["wfs"]["mmse_rms"], rel=0.01)
    m = mcao_demo.main(cuda_device)
    np.testing.assert_allclose(m["two_dm"]["target_vars_rad2"],
                               ref["mcao"]["two_dm"]["target_vars_rad2"],
                               rtol=1e-6)
    np.testing.assert_allclose(m["monte_carlo_rad2"],
                               ref["mcao"]["monte_carlo_rad2"], rtol=1e-3)


# --------------------------------------- the experiment protocols, timers

@pytest.mark.gpu
def test_protocol_rows_on_card_match_cpu(cuda_device):
    """protocol_sweep's reference build at R=64 (300/50 split, 16 steps)
    on the card, its D/r0 grid 5/10/15/20 as 4 shared-window scenarios
    with injected noise, against the same operators on the CPU (plain
    versions): B1 launches 16 x (1 + gauss_newton_iters), residual RMS
    rtol 0.01 / atol 5e-3, u atol 0.02 max|u|, and the settled rows'
    residual and Strehl to the same tolerances."""
    from mpc_sensorlessao_tpu_torch.benchmarks import _protocol as P
    from mpc_sensorlessao_tpu_torch.benchmarks import protocol_sweep as ps
    cfg = ps.base_cfg(64, {"PROTO_TRAIN": "300", "PROTO_STEPS": "16"})
    sys_ = pipeline.build(cfg, cuda_device)
    n, d_grid = cfg.sim.n_test, (5.0, 10.0, 15.0, 20.0)
    scen = ps.reference_scenarios(cfg, d_grid, cuda_device)
    noise = torch.as_tensor((float(sys_.est.noise_std)
                             * np.random.default_rng(6).standard_normal(
                                 (4, n, sys_.est.n_pixels))
                             ).astype(np.float32))
    kw = dict(n_steps=n, start_step=cfg.sim.n_train + cfg.sim.n_valid)
    b1 = psf_kernels.psf_crop_diversity_sym3
    before = b1.launches
    got = closed_loop.simulate(sys_.loop, sys_.layers, cfg, None,
                               mag=scen.mag, noise_seq=noise.to(cuda_device),
                               **kw)
    torch.cuda.synchronize()
    assert b1.launches - before == n * (1 + cfg.estimator.gauss_newton_iters)
    want = closed_loop.simulate(
        tree.cast(sys_.loop, device="cpu"),
        tree.cast(sys_.layers, device="cpu"), cfg, None,
        mag=scen.mag.cpu(), noise_seq=noise, **kw)
    torch.testing.assert_close(got.rms_res.cpu(), want.rms_res, rtol=0.01,
                               atol=5e-3)
    torch.testing.assert_close(got.u.cpu(), want.u, rtol=0,
                               atol=0.02 * float(want.u.abs().max()))
    for i in range(4):
        a, b = P.settled_row(got, i), P.settled_row(want, i)
        assert a["finite"] and b["finite"]
        np.testing.assert_allclose(a["mean_rms_res_rad"],
                                   b["mean_rms_res_rad"], rtol=0.01,
                                   atol=5e-3)
        np.testing.assert_allclose(a["mean_strehl"], b["mean_strehl"],
                                   atol=5e-3)


@pytest.mark.gpu
def test_latency_step_on_card_matches_cpu(cuda_device):
    """latency_b1's B=1 step at R=64 (BENCH_GN=0), 20 steps with injected
    noise: B1 launches exactly once a step on the card, and the run
    agrees with the CPU's on the same operators (residual RMS rtol 0.01
    / atol 5e-3, u atol 0.02 max|u|); the entry point's card row counts
    1 launch a step and gives both timings."""
    from mpc_sensorlessao_tpu_torch.benchmarks import latency_b1 as lb
    cfg = lb.latency_cfg(64, 0)
    sys_ = pipeline.build(cfg, cuda_device)
    n = 20
    noise = torch.as_tensor((float(sys_.est.noise_std)
                             * np.random.default_rng(7).standard_normal(
                                 (n, sys_.est.n_pixels))).astype(np.float32))
    b1 = psf_kernels.psf_crop_diversity_sym3
    before = b1.launches
    got = lb.step_run(sys_, cfg, n, noise_seq=noise.to(cuda_device))
    torch.cuda.synchronize()
    assert b1.launches - before == n
    cpu = dataclasses.replace(sys_, loop=tree.cast(sys_.loop, device="cpu"),
                              layers=tree.cast(sys_.layers, device="cpu"))
    want = lb.step_run(cpu, cfg, n, noise_seq=noise)
    assert got.rms_res.shape == (n,)
    torch.testing.assert_close(got.rms_res.cpu(), want.rms_res, rtol=0.01,
                               atol=5e-3)
    torch.testing.assert_close(got.u.cpu(), want.u, rtol=0,
                               atol=0.02 * float(want.u.abs().max()))
    row = lb.row(64, 10, 3, 0, cuda_device)
    assert row["b1_launches_per_step"] == 1
    assert row["ms_per_step_b1"] > 0 and row["host_ms_per_step_b1"] > 0


@pytest.mark.gpu
def test_span_encloses_its_launch_in_a_cuda_trace(cuda_device, tmp_path):
    """Under a profiler of the device activity alone (the benchmark's),
    a span around one launch encloses that launch's cudaLaunchKernel
    event: the span's stamps and CUPTI's share one clock."""
    x = torch.ones(1 << 20, device=cuda_device)
    x + 1
    torch.cuda.synchronize()
    profiling.take_spans()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        with profiling.span("add"):
            x + 1
        torch.cuda.synchronize()
    (span,) = profiling.take_spans()
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    doc = json.loads((tmp_path / "trace.json").read_text())
    base = int(doc.get("baseTimeNanoseconds", 0))
    (launch,) = [e for e in doc["traceEvents"]
                 if e.get("name") == "cudaLaunchKernel"]
    start = base + launch["ts"] * 1e3
    assert span.start_ns <= start
    assert start + launch["dur"] * 1e3 <= span.end_ns
