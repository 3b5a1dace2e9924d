"""Kernel B1's bf16 entry on its Hopper engine (csrc/psf_wgmma.cuh): the
kernel's arithmetic emulated on the CPU and held against the Pallas
kernel's compute_dtype="bfloat16" branch in interpret mode.

The emulation follows the kernel's rounding points and summation
grouping: the operator and the six parts of the pseudo-fields P = (t1,
t3), F_0 and Q = (t2, -t4) rounded to bf16 once; stage 1 as separate
sums of the stacked operator's rows (are, aim) with each part, chained
over K in k16 slices as wgmma accumulates; the fields' sums recombined
in float32 (F_-a = P + Q, F_+a = P - Q), then rr = are fr - aim fi and
ri = are fi + aim fr, rounded to bf16 once; stage 2 as four chained sums
(rr and ri against are and aim) over the field's columns, and the
epilogue's orr = rr are' - ri aim', oi = rr aim' + ri are',
(orr^2 + oi^2) scale.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_sensorlessao_tpu.ops import dft as jdft
from mpc_sensorlessao_tpu.ops import pallas_kernels as jpk
from mpc_sensorlessao_tpu.ops import psf as jpsf
from mpc_sensorlessao_tpu_torch.benchmarks import bf16_knockouts
from mpc_sensorlessao_tpu_torch.ops import cuda_build, dft, psf, psf_kernels

torch.set_num_threads(1)

# chip_smoke.py's limit for B1's bf16 entry against its plain version, of
# the peak: the card's reading is held to it, and the emulation to the
# JAX branch here
BF16_ATOL = 4e-5


def _rtz_f32(x: torch.Tensor) -> torch.Tensor:
    """float64 ``x`` to float32, rounded toward zero."""
    y = x.float()
    return torch.where(y.double().abs() > x.abs(),
                       torch.nextafter(y, torch.zeros_like(y)), y)


def _chain(a: torch.Tensor, b: torch.Tensor, rtz: bool) -> torch.Tensor:
    """a @ b (bf16 values in float32) as one wgmma accumulator takes it:
    k16 slice by k16 slice, each adding its 16 exact products to the
    float32 sum and rounding toward zero (the tensor cores' accumulation,
    modelled), or to nearest where not ``rtz``.  The kernel's zero
    padding of K to whole stages adds exact zeros and is left out."""
    c = None
    for k0 in range(0, a.shape[-1], 16):
        part = a[..., k0:k0 + 16].double() @ b[..., k0:k0 + 16, :].double()
        part = part if c is None else c.double() + part
        c = _rtz_f32(part) if rtz else part.float()
    return c


def _wgmma_b1_bf16(phase, pupil, cos_a, sin_a, dft_op, scale, rtz=True,
                   round_fields=False):
    """The kernel's arithmetic on the CPU (module docstring).
    ``round_fields`` rounds the +-a fields as formed in float32, instead
    of the four products: the rounding that B1's bf16 limit must catch."""
    bf = psf_kernels._bf16
    c, s = torch.cos(phase), torch.sin(phase)
    pcd, psd = pupil * cos_a, pupil * sin_a
    t1, t2, t3, t4 = c * pcd, s * psd, s * pcd, c * psd
    if round_fields:
        parts = [t1 + t2, t3 - t4, pupil * c, pupil * s, t1 - t2, t3 + t4]
    else:
        parts = [t1, t3, pupil * c, pupil * s, t2, -t4]
    T = bf(torch.stack(parts, dim=1))[:, :, None]               # (B,6,1,R,R)
    are, aim = bf(dft_op.real), bf(dft_op.imag)
    S = _chain(torch.stack([are, aim]), T, rtz)                 # (B,6,2,w,R)
    if round_fields:
        re, im = S[:, 0::2], S[:, 1::2]                         # (B,3,2,w,R)
    else:
        re = torch.stack([S[:, 0] + S[:, 4], S[:, 2], S[:, 0] - S[:, 4]], 1)
        im = torch.stack([S[:, 1] + S[:, 5], S[:, 3], S[:, 1] - S[:, 5]], 1)
    rr = bf(re[:, :, 0] - im[:, :, 1])                          # (B,3,w,R)
    ri = bf(im[:, :, 0] + re[:, :, 1])
    G = torch.stack([rr, ri], dim=2)[:, :, :, None]            # (B,3,2,1,w,R)
    A = torch.stack([are, aim]).transpose(-1, -2)               # (2,R,w)
    S2 = _chain(G, A, rtz)                                      # (B,3,2,2,w,w)
    orr = S2[:, :, 0, 0] - S2[:, :, 1, 1]
    oi = S2[:, :, 0, 1] + S2[:, :, 1, 0]
    return (orr * orr + oi * oi) * scale


def _case(c: int):
    """(numpy-seeded B1 inputs as torch tensors, the JAX kernel's bf16
    branch in interpret mode on the same inputs) at R=64, B=4, a=3, a
    (2c + 1)-px crop and a unit-peak scale."""
    R, B, a = 64, 4, 3.0
    rng = np.random.default_rng(1)
    phase = (rng.normal(size=(B, R, R)) * 0.4).astype(np.float32)
    zmap = (rng.normal(size=(R, R)) * 0.5).astype(np.float32)
    cos_a = np.cos(a * zmap).astype(np.float32)
    sin_a = np.sin(a * zmap).astype(np.float32)
    scale = 1.0 / float(jpsf.pupil_mask_np(R).sum()) ** 2
    want = jpk.psf_crop_diversity_sym3(
        jnp.asarray(phase), jpsf.pupil_mask(R), jnp.asarray(cos_a),
        jnp.asarray(sin_a), jdft.centered_partial_dft(R, c), scale,
        interpret=True, compute_dtype="bfloat16")
    args = (torch.as_tensor(phase), psf.pupil_mask(R, device="cpu"),
            torch.as_tensor(cos_a), torch.as_tensor(sin_a),
            dft.centered_partial_dft(R, c, device="cpu"), scale)
    return args, np.asarray(want)


@pytest.fixture(scope="module", params=[15, 20], ids=["w31", "w41"])
def case(request):
    return _case(request.param)


@pytest.mark.parametrize("rtz", [True, False], ids=["rtz", "nearest"])
def test_wgmma_arithmetic_matches_jax_bf16_branch(case, rtz):
    """The emulated kernel == the JAX kernel's bf16 branch (interpret
    mode) within BF16_ATOL of the peak, at w = 31 (2w = 62 rows: one M=64
    tile) and w = 41 (2w = 82 > 64: two crop bands), with the tensor
    cores' sums rounded toward zero or to nearest: the kernel computes
    the bf16 function, whichever way its accumulator rounds (2.1e-7 to
    1.5e-6 of the peak here; the JAX branch's own float32 sums differ
    from the plain version's by up to 1.5e-6).  The limit is the card's:
    a bf16 rounding that a sum's last bit flips moves a pixel by ~1e-5 of
    the peak (chip_smoke.py's BF16_ATOL)."""
    args, want = case
    got = _wgmma_b1_bf16(*args, rtz=rtz).numpy()
    assert got.shape == want.shape == (4, 3) + want.shape[-2:]
    peak = float(np.abs(want).max())
    assert float(np.abs(got - want).max()) <= BF16_ATOL * peak


def test_wgmma_grouping_is_the_plain_versions_to_float32_error(case):
    """With sums rounded to nearest, the emulated kernel == the plain
    version's bf16 branch to 1e-7 of the peak (1.1e-8 here): its grouping
    (part sums, then P +- Q, then rr / ri) is the TPU kernel's U +- W,
    and the plain version's differs from it by float32 reassociation
    alone."""
    args, _ = case
    want = psf_kernels.psf_crop_diversity_sym3_ref(
        *args, compute_dtype="bfloat16")
    got = _wgmma_b1_bf16(*args, rtz=False)
    peak = float(want.abs().max())
    assert float((got - want).abs().max()) <= 1e-7 * peak


def test_bf16_limit_catches_rounded_fields(case):
    """The same arithmetic rounding the +-a fields, instead of the four
    products, misses the JAX branch by more than BF16_ATOL of the peak
    (8.1e-5 here): the limit tells the kernel's rounding points from the
    wrong ones."""
    args, want = case
    got = _wgmma_b1_bf16(*args, round_fields=True).numpy()
    peak = float(np.abs(want).max())
    assert float(np.abs(got - want).max()) > BF16_ATOL * peak


@pytest.mark.parametrize("build", sorted(bf16_knockouts.BUILDS))
def test_knockout_builds_patch_the_current_sources(build, tmp_path):
    """Each knock-out build of benchmarks/bf16_knockouts.py finds its text
    once in the current csrc/ and changes it (nvcc runs only on the
    card): the split stays tied to the sources it measures."""
    dest = bf16_knockouts.patched_sources(build, tmp_path)
    changed = [src.name for src in cuda_build.CSRC.iterdir()
               if (dest / src.name).read_text() != src.read_text()]
    assert bool(changed) == (not build.endswith("_full"))
