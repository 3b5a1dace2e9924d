"""Kernels B2 and B3 on the Hopper engine (csrc/psf_wgmma.cuh, its div
and crop policies), and B4 on its sym3 policy, bf16 and float32
entries: their arithmetic emulated on the CPU and held against the
Pallas kernels' compute_dtype="bfloat16" branches and float32 branches
in interpret mode (the float32 ones also against the plain versions;
see _wgmma_tf32; B4's against both branches' plain versions).

In bf16 both policies round where their TPU kernels round: the
operator, each field's (re, im) as formed in float32 -- B2's from
rounded products, c pcd - s psd and s pcd + c psd (pcd, psd = pupil cos,
pupil sin of the diversity map), B3's pupil (cos, sin) of each total
phase -- and each field's stage-1 rows.  Stage 1 sums the stacked operator's rows (are,
aim) against each part, chained over K in k16 slices as one wgmma
accumulator takes them (test_torch_b1_wgmma._chain); rr = S[are][re] -
S[aim][im] and ri = S[are][im] + S[aim][re] in float32, rounded to bf16
once; stage 2 and the epilogue as in B1's sym3 policy.  Neither policy
recombines its fields.  Which scenario, diversity group or phase triple
a consumer takes changes no sum: every field runs the same chains.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_sensorlessao_tpu.ops import dft as jdft
from mpc_sensorlessao_tpu.ops import pallas_kernels as jpk
from mpc_sensorlessao_tpu.ops import psf as jpsf
from mpc_sensorlessao_tpu_torch.ops import dft, psf, psf_kernels, zernike
from test_torch_b1_wgmma import (BF16_ATOL, _chain, _chain_tf32, _stage2_tf32,
                                 _wgmma_b1_bf16, _wgmma_b1_tf32)

torch.set_num_threads(1)

# chip_smoke.py's limit for B2's bf16 entry on random diversity maps, of
# the peak: speckle makes a flipped stage-1 rounding move a pixel by more
BF16_ATOL_RANDOM_MAPS = 2e-4
R, B, A = 64, 4, 3.0


def _wgmma(fre: torch.Tensor, fim: torch.Tensor, dft_op: torch.Tensor,
           scale: float, rtz: bool = True, rows: bool = False):
    """The engine's arithmetic for fields that are not recombined: their
    float32 parts fre, fim (..., R, R) -> crops (..., w, w); with
    ``rows`` also the float32 stage-1 rows (rr, ri) before rounding."""
    bf = psf_kernels._bf16
    T = bf(torch.stack([fre, fim], dim=-3))[..., None, :, :]   # (...,2,1,R,R)
    are, aim = bf(dft_op.real), bf(dft_op.imag)
    S = _chain(torch.stack([are, aim]), T, rtz)                # (...,2,2,w,R)
    re, im = S[..., 0, :, :, :], S[..., 1, :, :, :]            # rows are, aim
    g = (re[..., 0, :, :] - im[..., 1, :, :],
         im[..., 0, :, :] + re[..., 1, :, :])
    G = torch.stack([bf(g[0]), bf(g[1])], dim=-3)[..., None, :, :]
    S2 = _chain(G, torch.stack([are, aim]).transpose(-1, -2), rtz)
    orr = S2[..., 0, 0, :, :] - S2[..., 1, 1, :, :]
    oi = S2[..., 0, 1, :, :] + S2[..., 1, 0, :, :]
    crops = (orr * orr + oi * oi) * scale
    return (crops, g) if rows else crops


def _plain_rows(fre, fim, dft_op):
    """The plain version's float32 stage-1 rows (rr, ri) before rounding
    (psf_kernels._intensity_bf16)."""
    bf = psf_kernels._bf16
    are, aim, fre, fim = (bf(dft_op.real), bf(dft_op.imag), bf(fre),
                          bf(fim))
    return are @ fre - aim @ fim, are @ fim + aim @ fre


def _div_fields(phase, pupil, div_cos, div_sin, fma=False):
    """B2's parts, (B, n_div, R, R) each: every product rounded, then
    their sum; with ``fma`` the first product of each sum is left
    unrounded, as a fused multiply-add takes it."""
    c, s = torch.cos(phase)[:, None], torch.sin(phase)[:, None]
    pcd, psd = pupil * div_cos, pupil * div_sin
    if fma:
        return ((c.double() * pcd.double() - (s * psd).double()).float(),
                (s.double() * pcd.double() + (c * psd).double()).float())
    return c * pcd - s * psd, s * pcd + c * psd


def _crop_fields(total, pupil):
    """B3's parts, (N, R, R) each."""
    return pupil * torch.cos(total), pupil * torch.sin(total)


def _case(kind: str, c: int):
    """(the policy's float32 parts (fre, fim), the operator, the scale,
    the plain version's bf16 output, the JAX kernel's bf16 branch in
    interpret mode, the limit of the peak) on
    numpy-seeded phases at R=64, B=4, a (2c + 1)-px crop and a unit-peak
    scale: B2 on the symmetric defocus triple (-a, 0, +a) Z4 (the loop's
    div_sym3=False route) or on 5 random maps (a group of 3 and a ragged
    one of 2), B3 on the first N=7 of the scenarios' 12 total phases (two
    triples and a ragged one)."""
    rng = np.random.default_rng(3)
    phase = (rng.normal(size=(B, R, R)) * 0.4).astype(np.float32)
    z4 = zernike.make_basis(6, R, device="cpu").stack[4].numpy()
    triple = np.stack([-A * z4, 0.0 * z4, A * z4]).astype(np.float32)
    scale = 1.0 / float(jpsf.pupil_mask_np(R).sum()) ** 2
    jop, op = (jdft.centered_partial_dft(R, c),
               dft.centered_partial_dft(R, c, device="cpu"))
    jpupil, pupil = jpsf.pupil_mask(R), psf.pupil_mask(R, device="cpu")
    if kind == "b3":
        total = (phase[:, None] + triple).reshape(-1, R, R)[:7]
        want = jpk.psf_crop_intensity(jnp.asarray(total), jpupil, jop, scale,
                                      interpret=True,
                                      compute_dtype="bfloat16")
        args = (torch.as_tensor(total), pupil, op, scale)
        plain = psf_kernels.psf_crop_intensity_ref(*args,
                                                   compute_dtype="bfloat16")
        return (_crop_fields(*args[:2]), op, scale, plain, np.asarray(want),
                BF16_ATOL)
    if kind == "b2_triple":
        div, limit = triple, BF16_ATOL
    else:
        div = (rng.normal(size=(5, R, R)) * 0.8).astype(np.float32)
        limit = BF16_ATOL_RANDOM_MAPS
    div_cos, div_sin = np.cos(div), np.sin(div)
    want = jpk.psf_crop_diversity(
        jnp.asarray(phase), jpupil, jnp.asarray(div_cos),
        jnp.asarray(div_sin), jop, scale, interpret=True,
        compute_dtype="bfloat16")
    args = (torch.as_tensor(phase), pupil, torch.as_tensor(div_cos),
            torch.as_tensor(div_sin), op, scale)
    plain = psf_kernels.psf_crop_diversity_ref(*args,
                                               compute_dtype="bfloat16")
    return _div_fields(*args[:4]), op, scale, plain, np.asarray(want), limit


@pytest.fixture(scope="module", params=[
    ("b2_triple", 15), ("b2_random5", 15), ("b3", 15),
    ("b2_triple", 20), ("b2_random5", 20), ("b3", 20)],
    ids=lambda p: f"{p[0]}-w{2 * p[1] + 1}")
def case(request):
    return request.param[0], _case(*request.param)


@pytest.mark.parametrize("rtz", [True, False], ids=["rtz", "nearest"])
def test_policy_arithmetic_matches_jax_bf16_branch(case, rtz):
    """The emulated policy == its JAX kernel's bf16 branch (interpret
    mode) within the card's limit of the peak -- 4e-5 on the real
    diversity, 2e-4 on random maps -- at w = 31 (one M=64 tile) and 41
    (two crop bands), with the tensor cores' sums rounded toward zero or
    to nearest: the kernel computes the bf16 function whichever way its
    accumulator rounds.  The shapes are the JAX kernel's: (B, n_div, w,
    w) for B2, (N, w, w) for B3."""
    kind, (fields, op, scale, _, want, limit) = case
    got = _wgmma(*fields, op, scale, rtz=rtz).numpy()
    n = {"b2_triple": (B, 3), "b2_random5": (B, 5), "b3": (7,)}[kind]
    assert got.shape == want.shape == n + want.shape[-2:]
    peak = float(np.abs(want).max())
    assert float(np.abs(got - want).max()) <= limit * peak


def test_policy_grouping_is_the_plain_versions_to_float32_error(case):
    """With sums rounded to nearest, the emulated policy's float32
    stage-1 rows == the plain version's bf16 branch's to 4e-7 of their
    largest, a few float32 rounding steps (1.9e-7 here): its grouping
    (stage-1 part sums, then rr / ri) is the TPU kernels' S1[:w, :R] -
    S1[w:, R:], and the plain version's differs from it by float32
    reassociation alone.  Their crops agree to 1e-6 of the peak: to 1.3e-8
    where no bf16 rounding of a stage-1 element flips, and where that
    reassociation flips one (1 of 23,808 elements of rr, and of ri, on
    the triple here) a pixel moves by 4.5e-7 of the peak."""
    _, (fields, op, scale, plain, _, _) = case
    got, rows = _wgmma(*fields, op, scale, rtz=False, rows=True)
    for g, p in zip(rows, _plain_rows(*fields, op)):
        assert float((g - p).abs().max()) <= 4e-7 * float(p.abs().max())
    peak = float(plain.abs().max())
    assert float((got - plain).abs().max()) <= 1e-6 * peak


def test_fused_forming_flips_the_fields_bf16_rounding():
    """B2's forming, each product rounded and then their sum (the div
    policy's __fmul_rn), gives the plain version's bf16 fields bit for bit
    on 5 random maps at R=128, B=16 (1,310,720 parts each of re and im);
    the same sums with the first product left unrounded -- a fused
    multiply-add, as nvcc contracts c pcd - s psd unless told not to --
    round 9 of the re parts and 21 of the im parts the other way.  One
    flipped field rounding moves a crop by far less than the random-map
    limit (BF16_ATOL_RANDOM_MAPS) at any size a CPU test can run, so the
    rounding points are held here on the fields themselves."""
    R2, B2 = 128, 16
    rng = np.random.default_rng(5)
    phase = torch.as_tensor((rng.normal(size=(B2, R2, R2)) * 0.4).astype(
        np.float32))
    div = torch.as_tensor((rng.normal(size=(5, R2, R2)) * 0.8).astype(
        np.float32))
    pupil = psf.pupil_mask(R2, device="cpu")
    c, s = torch.cos(phase)[:, None], torch.sin(phase)[:, None]
    dc, ds = torch.cos(div), torch.sin(div)
    bf = psf_kernels._bf16
    # psf_crop_diversity_ref's fields
    want = (bf(pupil * (c * dc - s * ds)), bf(pupil * (s * dc + c * ds)))
    got = _div_fields(phase, pupil, dc, ds)
    fused = _div_fields(phase, pupil, dc, ds, fma=True)
    for g, f, w in zip(got, fused, want):
        assert torch.equal(bf(g), w)
        assert int((bf(f) != w).sum()) > 0


# B2's and B3's float32 entries on the same engine in 3xTF32
# (psf_wgmma.cuh's block_tf32, the div and crop policies' Div<true> and
# Crop<true>): the parts formed in float32 as above, every operand split
# into TF32 hi and lo, no recombination, and otherwise B1 float32's
# arithmetic (test_torch_b1_wgmma._wgmma_b1_tf32)


def _wgmma_tf32(fre: torch.Tensor, fim: torch.Tensor, dft_op: torch.Tensor,
                scale: float, rtz: bool = True, stage1=("hh", "lh hl")):
    """The engine's 3xTF32 arithmetic for fields that are not
    recombined: their float32 parts fre, fim (..., R, R) -> crops (...,
    w, w).  Stage 1 as separate chains of the stacked operator's rows
    (are, aim) with each part over K = R, one chain a product group of
    ``stage1`` (the kernel's: hi*hi in S, lo*hi and hi*lo in C), added in
    float32; rr = S[are][re] - S[aim][im], ri = S[are][im] + S[aim][re];
    stage 2 and the epilogue as _stage2_tf32 (one TF32 pass, hi*hi
    alone, where ``stage1`` is ("hh",))."""
    T = torch.stack([fre, fim], dim=-3)[..., None, :, :]       # (...,2,1,R,R)
    A2 = torch.stack([dft_op.real, dft_op.imag])                # (2,w,R)
    S = sum(_chain_tf32(A2, T, rtz, p) for p in stage1)         # (...,2,2,w,R)
    re, im = S[..., 0, :, :, :], S[..., 1, :, :, :]            # rows are, aim
    rr = re[..., 0, :, :] - im[..., 1, :, :]
    ri = im[..., 0, :, :] + re[..., 1, :, :]
    return _stage2_tf32(rr, ri, A2, scale, rtz, stage1 == ("hh",))


def _case32(kind: str, c: int):
    """(the policy's float32 parts, the operator, the scale, the float32
    plain version's output, the JAX kernel's float32 branch in interpret
    mode) on _case's inputs."""
    rng = np.random.default_rng(3)
    phase = (rng.normal(size=(B, R, R)) * 0.4).astype(np.float32)
    z4 = zernike.make_basis(6, R, device="cpu").stack[4].numpy()
    triple = np.stack([-A * z4, 0.0 * z4, A * z4]).astype(np.float32)
    scale = 1.0 / float(jpsf.pupil_mask_np(R).sum()) ** 2
    jop, op = (jdft.centered_partial_dft(R, c),
               dft.centered_partial_dft(R, c, device="cpu"))
    jpupil, pupil = jpsf.pupil_mask(R), psf.pupil_mask(R, device="cpu")
    if kind == "b3":
        total = (phase[:, None] + triple).reshape(-1, R, R)[:7]
        want = jpk.psf_crop_intensity(jnp.asarray(total), jpupil, jop, scale,
                                      interpret=True)
        args = (torch.as_tensor(total), pupil, op, scale)
        return (_crop_fields(*args[:2]), op, scale,
                psf_kernels.psf_crop_intensity_ref(*args), np.asarray(want))
    div = (triple if kind == "b2_triple" else
           (rng.normal(size=(5, R, R)) * 0.8).astype(np.float32))
    div_cos, div_sin = np.cos(div), np.sin(div)
    want = jpk.psf_crop_diversity(
        jnp.asarray(phase), jpupil, jnp.asarray(div_cos),
        jnp.asarray(div_sin), jop, scale, interpret=True)
    args = (torch.as_tensor(phase), pupil, torch.as_tensor(div_cos),
            torch.as_tensor(div_sin), op, scale)
    return (_div_fields(*args[:4]), op, scale,
            psf_kernels.psf_crop_diversity_ref(*args), np.asarray(want))


@pytest.fixture(scope="module", params=[
    ("b2_triple", 15), ("b2_random5", 15), ("b3", 15),
    ("b2_triple", 20), ("b2_random5", 20), ("b3", 20)],
    ids=lambda p: f"{p[0]}-w{2 * p[1] + 1}")
def case32(request):
    return request.param[0], _case32(*request.param)


@pytest.mark.parametrize("rtz", [True, False], ids=["rtz", "nearest"])
def test_tf32_policy_arithmetic_matches_jax_kernel_and_plain(case32, rtz):
    """B2's and B3's float32 arithmetic on the engine, emulated (the
    parts formed in float32, the TF32 splits, hi*hi and lo*hi + hi*lo in
    separate stage-1 sums, the fragments' K order, stage 2's partial sums
    a strip), == the Pallas kernel it replaces in interpret mode at that
    kernel's test tolerance (rtol 2e-4, atol 2e-4), and == the float32
    plain version within rtol 2e-4 and atol 1e-5 of the peak
    (chip_smoke.py's limit), whichever way the tensor cores' sums round,
    at w = 31 and 41 (two crop bands on the card); B2 on the real triple
    and on 5 random maps (a ragged group of 2 on the card), B3 on 7 total
    phases (a ragged triple).  It errs 2.1e-7 to 5.6e-7 of the peak
    against the plain version here."""
    kind, (fields, op, scale, plain, want) = case32
    got = _wgmma_tf32(*fields, op, scale, rtz=rtz)
    assert got.shape == plain.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)
    peak = float(plain.abs().max())
    torch.testing.assert_close(got, plain, rtol=2e-4, atol=1e-5 * peak)


@pytest.mark.parametrize("kind", ["b2_triple", "b3"])
def test_one_tf32_pass_misses_the_float32_limit_b2_b3(kind):
    """The same arithmetic with hi*hi alone (one TF32 pass) misses the
    float32 plain version by more than 1e-5 of the peak, for B2 and for
    B3 at w = 31 (6.0e-5 and 2.5e-5 here): the limit needs the three
    products."""
    fields, op, scale, plain, _ = _case32(kind, 15)
    got = _wgmma_tf32(*fields, op, scale, stage1=("hh",))
    peak = float(plain.abs().max())
    assert float((got - plain).abs().max()) > 1e-5 * peak


# Kernel B4 on the same engine: its entries psf_div3_sym_thin and
# psf_div3_sym_thin_bf16 instantiate B1's sym3 policy
# (psf_wgmma_sym3.cuh), so their arithmetic is B1's
# (test_torch_b1_wgmma._wgmma_b1_bf16 and _wgmma_b1_tf32), held here
# against the Pallas kernel B4 replaces, `_psf_div3_sym_thin_kernel`, in
# interpret mode and against B4's plain version


def _case_b4(c: int):
    """(numpy-seeded B4 inputs as torch tensors, the JAX thin kernel's
    float32 and bf16 branches in interpret mode on them, by
    compute_dtype) at R=64, B=4, the real defocus diversity a = 3, a
    (2c + 1)-px crop and a unit-peak scale."""
    rng = np.random.default_rng(4)
    phase = (rng.normal(size=(B, R, R)) * 0.4).astype(np.float32)
    z4 = zernike.make_basis(6, R, device="cpu").stack[4].numpy()
    cos_a = np.cos(A * z4).astype(np.float32)
    sin_a = np.sin(A * z4).astype(np.float32)
    scale = 1.0 / float(jpsf.pupil_mask_np(R).sum()) ** 2
    jargs = (jnp.asarray(phase), jpsf.pupil_mask(R), jnp.asarray(cos_a),
             jnp.asarray(sin_a), jdft.centered_partial_dft(R, c), scale)
    want = {dt: np.asarray(jpk.psf_crop_diversity_sym3_thin(
        *jargs, interpret=True, compute_dtype=dt))
        for dt in (None, "bfloat16")}
    args = (torch.as_tensor(phase), psf.pupil_mask(R, device="cpu"),
            torch.as_tensor(cos_a), torch.as_tensor(sin_a),
            dft.centered_partial_dft(R, c, device="cpu"), scale)
    return args, want


@pytest.fixture(scope="module", params=[15, 20], ids=["w31", "w41"])
def case_b4(request):
    return _case_b4(request.param)


@pytest.mark.parametrize("rtz", [True, False], ids=["rtz", "nearest"])
def test_b4_bf16_on_sym3_matches_jax_thin_kernel_and_plain(case_b4, rtz):
    """B4 bf16 on the engine, emulated (B1 bf16's arithmetic: P, F_0 and
    Q rounded once -- the thin kernel's six products, rounded as it
    rounds them --, their stage-1 sums recombined in float32, then rr /
    ri rounded once) == the JAX thin kernel's bf16 branch within
    BF16_ATOL of the peak, at w = 31 and 41 (two crop bands on the card),
    whichever way the tensor cores' sums round, and == B4's bf16 plain
    version within the same limit (7.4e-6 of the peak against either
    with sums rounded toward zero, 7e-8 to nearest, here)."""
    args, want = case_b4
    got = _wgmma_b1_bf16(*args, rtz=rtz)
    jax_bf16 = want["bfloat16"]
    assert got.shape == jax_bf16.shape == (B, 3) + jax_bf16.shape[-2:]
    peak = float(np.abs(jax_bf16).max())
    assert float(np.abs(got.numpy() - jax_bf16).max()) <= BF16_ATOL * peak
    plain = psf_kernels.psf_crop_diversity_sym3_thin_ref(
        *args, compute_dtype="bfloat16")
    peak = float(plain.abs().max())
    assert float((got - plain).abs().max()) <= BF16_ATOL * peak


@pytest.mark.parametrize("rtz", [True, False], ids=["rtz", "nearest"])
def test_b4_tf32_on_sym3_matches_jax_thin_kernel_and_plain(case_b4, rtz):
    """B4 float32 on the engine, emulated (B1 float32's 3xTF32
    arithmetic: hi*hi and lo*hi + hi*lo in separate stage-1 sums, P +- Q
    on the stage-1 rows, stage 2's partial sums a strip) == the JAX thin
    kernel's float32 branch at that kernel's test tolerance (rtol 2e-4,
    atol 2e-4), and == B4's float32 plain version within rtol 2e-4 and
    atol 1e-5 of the peak (chip_smoke.py's limit), whichever way the
    tensor cores' sums round, at w = 31 and 41 (1.4e-7 to 4.2e-7 of the
    peak against either here)."""
    args, want = case_b4
    got = _wgmma_b1_tf32(*args, rtz=rtz)
    plain = psf_kernels.psf_crop_diversity_sym3_thin_ref(*args)
    assert got.shape == plain.shape == want[None].shape
    np.testing.assert_allclose(got.numpy(), want[None], rtol=2e-4,
                               atol=2e-4)
    peak = float(plain.abs().max())
    torch.testing.assert_close(got, plain, rtol=2e-4, atol=1e-5 * peak)
