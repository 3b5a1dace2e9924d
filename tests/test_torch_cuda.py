"""The port's CUDA kernels on the card, against their plain versions.

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


@pytest.mark.gpu
def test_b1_wrapper_raises_on_bad_input(cuda_device):
    """On a CUDA tensor the wrapper launches or raises: a crop wider than
    the kernel's 32 and a float64 phase are refused, not rerouted."""
    args = list(_b1_args(64, 2, 9, cuda_device))
    with pytest.raises(TypeError, match="float32"):
        psf_kernels.psf_crop_diversity_sym3(args[0].double(), *args[1:])
    args[4] = dft.centered_partial_dft(64, 16, device=cuda_device)
    with pytest.raises(ValueError, match="crop width"):
        psf_kernels.psf_crop_diversity_sym3(*args)
