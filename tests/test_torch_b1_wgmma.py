"""Kernel B1 on its Hopper engine (csrc/psf_wgmma.cuh), bf16 and float32
entries: the kernel's arithmetic emulated on the CPU and held against the
Pallas kernel's compute_dtype="bfloat16" branch and its float32 branch in
interpret mode (the float32 one also against the plain version).

For the bf16 entry the emulation follows the kernel's rounding points and summation
grouping: the operator and the six parts of the pseudo-fields P = (t1,
t3), F_0 and Q = (t2, -t4) rounded to bf16 once; stage 1 as separate
sums of the stacked operator's rows (are, aim) with each part, chained
over K in k16 slices as wgmma accumulates; the fields' sums recombined
in float32 (F_-a = P + Q, F_+a = P - Q), then rr = are fr - aim fi and
ri = are fi + aim fr, rounded to bf16 once; stage 2 as four chained sums
(rr and ri against are and aim) over the field's columns, and the
epilogue's orr = rr are' - ri aim', oi = rr aim' + ri are',
(orr^2 + oi^2) scale.

The float32 entry (3xTF32, block_tf32) follows _wgmma_b1_tf32's
docstring: the same pseudo-fields, sums and recombination, every operand
split into TF32 hi and lo instead of rounded.
"""

import io
import subprocess
import tarfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_sensorlessao_tpu.ops import dft as jdft
from mpc_sensorlessao_tpu.ops import pallas_kernels as jpk
from mpc_sensorlessao_tpu.ops import psf as jpsf
from mpc_sensorlessao_tpu_torch.benchmarks import bf16_knockouts
from mpc_sensorlessao_tpu_torch.ops import cuda_build, dft, psf, psf_kernels
from mpc_sensorlessao_tpu_torch.ops import zernike

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


# B1 float32 on the same engine in 3xTF32 (psf_wgmma.cuh's block_tf32)


def _tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """float32 to the nearest TF32, ties away from zero, as
    cvt.rna.tf32.f32: add half of the 13 dropped bits, then drop them."""
    return ((x.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def _split(x: torch.Tensor):
    """x = hi + lo to float32 accuracy, both TF32 (psf_wgmma::split)."""
    hi = _tf32_rna(x)
    return hi, _tf32_rna(x - hi)


def _chain_tf32(a: torch.Tensor, b: torch.Tensor, rtz: bool,
                products: str = "lh hl hh") -> torch.Tensor:
    """a @ b (float32) as one wgmma accumulator takes it: both split into
    TF32 hi and lo, then k8 step by k8 step each of ``products`` in turn
    (lh = lo*hi, hl = hi*lo, hh = hi*hi), each adding its 8 exact products
    to the float32 sum and rounding toward zero (or to nearest where not
    ``rtz``).  Zero padding of K adds exact zeros and is left out."""
    a_hi, a_lo = _split(a)
    b_hi, b_lo = _split(b)
    ops = {"lh": (a_lo, b_hi), "hl": (a_hi, b_lo), "hh": (a_hi, b_hi)}
    pairs = [ops[p] for p in products.split()]
    c = None
    for k0 in range(0, a.shape[-1], 8):
        for x, y in pairs:
            part = x[..., k0:k0 + 8].double() @ y[..., k0:k0 + 8, :].double()
            part = part if c is None else c.double() + part
            c = _rtz_f32(part) if rtz else part.float()
    return c


# stage 2's K order in each 8-group of a strip: register fragment index
# t (t + 4) holds the accumulator's column 2 t (2 t + 1)
_PI = [0, 2, 4, 6, 1, 3, 5, 7]


def _wgmma_b1_tf32(phase, pupil, cos_a, sin_a, dft_op, scale, rtz=True,
                   stage1=("hh", "lh hl")):
    """B1 float32's arithmetic on the engine, emulated: the pseudo-fields
    P = (t1, t3), F_0 and Q = (t2, -t4) formed in float32; stage 1 as
    separate chains of the stacked operator's rows (are, aim) with each
    part over K = R, one chain a product group of ``stage1`` (the
    kernel's: hi*hi in S, lo*hi and hi*lo in C), added in float32; the
    fields' rows recombined in float32 (F_-a = P + Q, F_+a = P - Q), then
    rr = are fr - aim fi, ri = are fi + aim fr; stage 2 a 16-column strip
    at a time, its K in the fragments' order (_PI), each strip's 3xTF32
    chain from zero added to O in float32 (one TF32 pass, hi*hi alone,
    where ``stage1`` is ("hh",)); the epilogue's (orr^2 + oi^2) scale."""
    c, s = torch.cos(phase), torch.sin(phase)
    pcd, psd = pupil * cos_a, pupil * sin_a
    t1, t2, t3, t4 = c * pcd, s * psd, s * pcd, c * psd
    T = torch.stack([t1, t3, pupil * c, pupil * s, t2, -t4],
                    dim=1)[:, :, None]                          # (B,6,1,R,R)
    A2 = torch.stack([dft_op.real, dft_op.imag])                # (2,w,R)
    S = sum(_chain_tf32(A2, T, rtz, p) for p in stage1)         # (B,6,2,w,R)
    re = torch.stack([S[:, 0] + S[:, 4], S[:, 2], S[:, 0] - S[:, 4]], 1)
    im = torch.stack([S[:, 1] + S[:, 5], S[:, 3], S[:, 1] - S[:, 5]], 1)
    rr = re[:, :, 0] - im[:, :, 1]                              # (B,3,w,R)
    ri = im[:, :, 0] + re[:, :, 1]
    return _stage2_tf32(rr, ri, A2, scale, rtz, stage1 == ("hh",))


def _stage2_tf32(rr, ri, A2, scale, rtz, one_pass=False):
    """Stage 2 and the epilogue of the 3xTF32 block from the float32
    stage-1 rows rr, ri (..., w, R) and the stacked operator A2 (2, w, R):
    a 16-column strip at a time, its K in the fragments' order (_PI),
    each strip's chain (lo*hi, hi*lo, hi*hi; hi*hi alone with
    ``one_pass``) from zero added to O in float32, then (orr^2 + oi^2)
    scale."""
    G = torch.stack([rr, ri], dim=-3)[..., None, :, :]         # (...,2,1,w,R)
    AT = A2.transpose(-1, -2)                                   # (2,R,w)
    products2 = "hh" if one_pass else "lh hl hh"
    O = 0.0
    for y0 in range(0, rr.shape[-1], 16):
        cols = [y0 + 8 * (j // 8) + _PI[j % 8] for j in range(16)]
        O = O + _chain_tf32(G[..., cols], AT[:, cols], rtz, products2)
    orr = O[..., 0, 0, :, :] - O[..., 1, 1, :, :]
    oi = O[..., 0, 1, :, :] + O[..., 1, 0, :, :]
    return (orr * orr + oi * oi) * scale


def _case32(c: int):
    """_case's inputs, with the JAX kernel's float32 branch in interpret
    mode and the float32 plain version."""
    args, _ = _case(c)
    phase, _, cos_a, sin_a, _, scale = args
    R = phase.shape[-1]
    want = jpk.psf_crop_diversity_sym3(
        jnp.asarray(phase.numpy()), jpsf.pupil_mask(R),
        jnp.asarray(cos_a.numpy()), jnp.asarray(sin_a.numpy()),
        jdft.centered_partial_dft(R, c), scale, interpret=True)
    return args, np.asarray(want), psf_kernels.psf_crop_diversity_sym3_ref(
        *args)


@pytest.fixture(scope="module", params=[15, 20], ids=["w31", "w41"])
def case32(request):
    return _case32(request.param)


@pytest.mark.parametrize("rtz", [True, False], ids=["rtz", "nearest"])
def test_b1_3xtf32_wgmma_arithmetic_matches_jax_kernel_and_plain(case32,
                                                                  rtz):
    """B1 float32's arithmetic on the engine, emulated (the TF32 splits,
    the three products a k8 step, the fragments' K order, P +- Q on the
    stage-1 rows, stage 2's partial sums a strip), == the Pallas kernel
    it replaces in interpret mode at that kernel's test tolerance (rtol
    2e-4, atol 2e-4), and == the float32 plain version within rtol 2e-4
    and atol 1e-5 of the peak (chip_smoke.py's limit), whichever way the
    tensor cores' sums round, at w = 31 and 41 (two crop bands on the
    card)."""
    args, want, plain = case32
    got = _wgmma_b1_tf32(*args, rtz=rtz)
    assert got.shape == plain.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)
    peak = float(plain.abs().max())
    torch.testing.assert_close(got, plain, rtol=2e-4, atol=1e-5 * peak)


def test_one_tf32_pass_misses_the_float32_limit(case32):
    """The same arithmetic with hi*hi alone (one TF32 pass) misses the
    float32 plain version by more than 1e-5 of the peak: the limit needs
    the three products."""
    args, _, plain = case32
    got = _wgmma_b1_tf32(*args, stage1=("hh",))
    peak = float(plain.abs().max())
    assert float((got - plain).abs().max()) > 1e-5 * peak


@pytest.mark.parametrize("R,B", [(128, 2), (512, 1)])
def test_split_stage1_sums_err_less_than_one_chain(R, B):
    """Stage 1's hi*hi in one accumulator and lo*hi + hi*lo in another
    (the kernel's S and C), against all three in one, with the tensor
    cores' sums rounded toward zero, on chip_smoke.py's inputs (speckled
    phases, the real defocus diversity, 31 px): one chain errs 1.0e-6
    (R=128) and 2.9e-6 (R=512) of the peak against the float32 plain
    version, the split sums 1.8e-7 and 3.5e-7 -- within 1e-6 at both and
    at least 4 times less: every wgmma on a large sum rounds it toward
    zero once, and the split sums take a third of those roundings."""
    rng = np.random.default_rng(0)
    phase = torch.as_tensor(
        (rng.normal(size=(B, R, R)) * 0.4).astype(np.float32))
    z4 = zernike.make_basis(6, R, device="cpu").stack[4]
    args = (phase, psf.pupil_mask(R, device="cpu"), torch.cos(3.0 * z4),
            torch.sin(3.0 * z4), dft.centered_partial_dft(R, 15, device="cpu"),
            2.0)
    plain = psf_kernels.psf_crop_diversity_sym3_ref(*args)
    peak = float(plain.abs().max())
    err = {}
    for name, stage1 in (("one", ("lh hl hh",)), ("split", ("hh", "lh hl"))):
        got = _wgmma_b1_tf32(*args, stage1=stage1)
        err[name] = float((got - plain).abs().max()) / peak
    assert err["split"] <= 1e-6 and err["one"] >= 4 * err["split"], err


@pytest.fixture(scope="module")
def old_csrc(tmp_path_factory):
    """csrc/ as the last commit that holds the mma.sync engine left it
    (bf16_knockouts.OLD_ENGINE_COMMIT), from the repository's history;
    None in a checkout without that history."""
    root = cuda_build.CSRC.parents[1]
    rel = cuda_build.CSRC.relative_to(root)
    try:
        blob = subprocess.run(
            ["git", "-C", str(root), "archive",
             bf16_knockouts.OLD_ENGINE_COMMIT, str(rel)],
            capture_output=True, check=True).stdout
    except (OSError, subprocess.CalledProcessError):
        return None
    dest = tmp_path_factory.mktemp("old_engine")
    with tarfile.open(fileobj=io.BytesIO(blob)) as tar:
        tar.extractall(dest, filter="data")
    return dest / rel


@pytest.mark.parametrize("build", sorted(bf16_knockouts.BUILDS))
def test_knockout_builds_patch_the_current_sources(build, tmp_path,
                                                   old_csrc):
    """Each knock-out build of benchmarks/bf16_knockouts.py finds its text
    once in the sources it measures and changes it (nvcc runs only on the
    card): the split stays tied to them.  The new and f32new builds patch
    the current csrc/.  The old and f32old builds, of the retired mma.sync
    engine, are refused on the current csrc/ with the --parent message,
    and patch the engine's last csrc/ (commit 19f54fa) where the
    repository's history holds it."""
    csrc, parent = cuda_build.CSRC, False
    design = build.split("_", 1)[0]
    if design in bf16_knockouts.PARENT_ENTRIES:
        with pytest.raises(ValueError, match="--parent DIR"):
            bf16_knockouts.patched_sources(build, tmp_path)
        if old_csrc is None:
            return
        csrc, parent = old_csrc, True
    dest = bf16_knockouts.patched_sources(build, tmp_path, csrc, parent)
    changed = [src.name for src in csrc.iterdir()
               if (dest / src.name).read_text() != src.read_text()]
    assert bool(changed) == (not build.endswith("_full"))
