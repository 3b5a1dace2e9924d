"""The port's CUDA kernels B1-B5 on the card, against their plain versions.

These tests need an NVIDIA GPU with nvcc (marker ``gpu``) and skip
without one.  They import neither jax nor the JAX package, so on the GPU
machine they run without the repo's conftest:

    python -m pytest --noconftest -m gpu tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from mpc_sensorlessao_tpu_torch.benchmarks import device_peaks
from mpc_sensorlessao_tpu_torch.ops import dft, psf, psf_kernels, zernike


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
                                   (512, 2, 15)])
def test_b1_cuda_kernel_matches_plain(cuda_device, R, B, c):
    """Kernel B1 vs its plain version on the card, including a grid that
    is not a multiple of the 32-px tile and a crop narrower than a warp:
    rtol 2e-4; atol 1e-5 of the batch's peak (both sum R^2 unit-modulus
    terms in float32 in different orders, an error that scales with the
    peak amplitude)."""
    args = _b1_args(R, B, c, cuda_device)
    before = psf_kernels.psf_crop_diversity_sym3.launches
    got = psf_kernels.psf_crop_diversity_sym3(*args)
    torch.cuda.synchronize()
    assert psf_kernels.psf_crop_diversity_sym3.launches == before + 1
    want = psf_kernels.psf_crop_diversity_sym3_ref(*args)
    assert got.shape == (B, 3, 2 * c + 1, 2 * c + 1)
    peak = float(want.abs().max())
    torch.testing.assert_close(got, want, rtol=2e-4, atol=1e-5 * peak)


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
@pytest.mark.parametrize("kernel", ["b1", "b2", "b3", "b4"])
def test_wrappers_raise_on_bad_input(cuda_device, kernel):
    """On a CUDA tensor each wrapper launches or raises: a float64 phase,
    a phase on another grid than the maps and a crop wider than the kernels' 32 are
    refused, not rerouted."""
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
    args[-2] = dft.centered_partial_dft(64, 16, device=cuda_device)
    with pytest.raises(ValueError, match="crop width"):
        wrapper(*args)
    assert wrapper.launches == before


CHAINS = {"b5a": (device_peaks.transc_sincos_chain,
                  device_peaks.transc_sincos_chain_ref, "transc_sincos"),
          "b5b": (device_peaks.transc_cos_chain,
                  device_peaks.transc_cos_chain_ref, "transc_cos")}


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
    """The built library's SASS has the link loop link_instructions looks
    for: one range check per element a thread carries (4), no MUFU
    (full-precision sincosf / cosf), and no more FP32 or issued
    instructions per element and link than the recorded counts the B5
    bound is computed from (device_peaks.LINK_INSTRUCTIONS)."""
    _, _, name = CHAINS[kernel]
    text = device_peaks.sass(name)
    assert "MUFU.SIN" not in text and "MUFU.COS" not in text
    got = device_peaks.link_instructions(text)
    recorded = device_peaks.LINK_INSTRUCTIONS[name]
    assert got["elements"] == 4
    assert 0 < got["fp32"] <= recorded["fp32"]
    assert got["fp32"] < got["issued"] <= recorded["issued"]


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
