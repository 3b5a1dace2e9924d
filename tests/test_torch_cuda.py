"""The port's CUDA kernels B1-B4 on the card, against their plain versions.

These tests need an NVIDIA GPU with nvcc (marker ``gpu``) and skip
without one.  They import neither jax nor the JAX package, so on the GPU
machine they run without the repo's conftest:

    python -m pytest --noconftest -m gpu tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

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
