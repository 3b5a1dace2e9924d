"""PyTorch port vs the JAX package, module by module, at small sizes.

The same numpy-seeded inputs go through the JAX function and its
counterpart in ``mpc_sensorlessao_tpu_torch``; results are compared as
numpy arrays with the tolerance stated at each check.  Where the JAX side
reaches a Pallas kernel (B1-B4) it runs in interpret mode, as
tests/test_pallas.py does; the port side runs the kernel's plain version
(its wrapper's choice for CPU tensors).
"""

import ast
import dataclasses
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_sensorlessao_tpu.models import closed_loop as jcl
from mpc_sensorlessao_tpu.models import dm as jdm
from mpc_sensorlessao_tpu.models import estimator as jestimator
from mpc_sensorlessao_tpu.models import mpc as jmpc
from mpc_sensorlessao_tpu.models import solvers as jsolvers
from mpc_sensorlessao_tpu.models import var as jvar
from mpc_sensorlessao_tpu.ops import dft as jdft
from mpc_sensorlessao_tpu.ops import newton_kkt as jnk
from mpc_sensorlessao_tpu.ops import pallas_kernels as jpk
from mpc_sensorlessao_tpu.ops import phase_screens as jps
from mpc_sensorlessao_tpu.ops import psf as jpsf
from mpc_sensorlessao_tpu.ops import zernike as jz
from mpc_sensorlessao_tpu.utils import config as jconfig
from mpc_sensorlessao_tpu.utils import metrics as jmetrics
from mpc_sensorlessao_tpu_torch import reference_config
from mpc_sensorlessao_tpu_torch.benchmarks import bench, cholesky_paths
from mpc_sensorlessao_tpu_torch.benchmarks import classical_vs_mpc
from mpc_sensorlessao_tpu_torch.benchmarks import edge_flow_breakdown
from mpc_sensorlessao_tpu_torch.benchmarks import edge_flow_cost
from mpc_sensorlessao_tpu_torch.benchmarks import excursion_tail
from mpc_sensorlessao_tpu_torch.benchmarks import full_protocol, latency_b1
from mpc_sensorlessao_tpu_torch.benchmarks import kernel_variants
from mpc_sensorlessao_tpu_torch.benchmarks import long_horizon, modes_horizon
from mpc_sensorlessao_tpu_torch.benchmarks import montecarlo_100k
from mpc_sensorlessao_tpu_torch.benchmarks import montecarlo_sweep
from mpc_sensorlessao_tpu_torch.benchmarks import multiprocess
from mpc_sensorlessao_tpu_torch.benchmarks import oracle_reference_rows
from mpc_sensorlessao_tpu_torch.benchmarks import protocol_edge
from mpc_sensorlessao_tpu_torch.benchmarks import protocol_sweep, scaling
from mpc_sensorlessao_tpu_torch.benchmarks import solver_throughput
from mpc_sensorlessao_tpu_torch.benchmarks import step_breakdown
from mpc_sensorlessao_tpu_torch.benchmarks import step_knockouts
from mpc_sensorlessao_tpu_torch.examples import closed_loop_demo, mcao_demo
from mpc_sensorlessao_tpu_torch.examples import horizon_sweep_demo, wfs_demo
from mpc_sensorlessao_tpu_torch.models import closed_loop, dm, estimator
from mpc_sensorlessao_tpu_torch.models import imaging, mpc, pipeline
from mpc_sensorlessao_tpu_torch.models import lgs, mcao, slopes_mmse
from mpc_sensorlessao_tpu_torch.models import pyramid, solvers, var, wfs
from mpc_sensorlessao_tpu_torch.models import tomography
from mpc_sensorlessao_tpu_torch.ops import dft, edge_flow, karhunen_loeve
from mpc_sensorlessao_tpu_torch.ops import newton_kkt
from mpc_sensorlessao_tpu_torch.ops import phase_screens
from mpc_sensorlessao_tpu_torch.ops import psf, psf_kernels, toeplitz
from mpc_sensorlessao_tpu_torch.ops import zernike
from mpc_sensorlessao_tpu_torch.parallel import dryrun, estimator_tp
from mpc_sensorlessao_tpu_torch.parallel import horizon, mesh, montecarlo
from mpc_sensorlessao_tpu_torch.parallel import multihost
from mpc_sensorlessao_tpu_torch.utils import metrics, tree

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
# the suite runs one test file per worker process, several at once: one
# intra-op thread each keeps torch's thread pools from oversubscribing the
# cores (which slows small eager ops many times over)
torch.set_num_threads(1)


def t32(a):
    return torch.as_tensor(np.array(a, dtype=np.float32))


def npy(t):
    return t.detach().cpu().numpy()


# ------------------------------------------------------------------ config

def test_config_copy_matches_jax():
    """The port's config module is a copy: same fields and defaults."""
    ours = reference_config(resolution=64)
    theirs = jconfig.reference_config(resolution=64)
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert ours.estimator.n_pixels == theirs.estimator.n_pixels
    assert ours.atmosphere.seeing_arcsec == theirs.atmosphere.seeing_arcsec


# ------------------------------------------------------------- basis, DFT

def test_zernike_basis_matches_jax():
    """Host float64 precompute rounded once to float32 in both packages:
    identical up to 1 ulp of the pinv (rtol 1e-6)."""
    ours = zernike.make_basis(6, 32, device="cpu")
    theirs = jz.make_basis(6, 32)
    for name in ("stack", "fit_full", "gram", "mode_mean"):
        np.testing.assert_allclose(npy(getattr(ours, name)),
                                   np.asarray(getattr(theirs, name)),
                                   rtol=1e-6, atol=1e-7, err_msg=name)
    assert np.array_equal(npy(ours.mask), np.asarray(theirs.mask))
    rng = np.random.default_rng(3)
    ph = rng.normal(size=(2, 32, 32)).astype(np.float32)
    mask = np.asarray(theirs.mask)
    got = zernike.piston_removed_phase_masked(t32(ph), ours.mask,
                                              float(mask.sum()))
    want = jz.piston_removed_phase_masked(jnp.asarray(ph), theirs.mask,
                                          float(mask.sum()))
    # float32 sums over 32^2 pixels in another order
    np.testing.assert_allclose(npy(got), np.asarray(want), atol=1e-6)


def test_partial_dft_operator_matches_jax():
    """Both round the float64 operator once: exactly equal."""
    A = npy(dft.centered_partial_dft(64, 9, device="cpu"))
    stack = np.asarray(jdft.centered_partial_dft(64, 9))
    assert A.dtype == np.complex64 and A.shape == (19, 64)
    np.testing.assert_array_equal(A.real, stack[0])
    np.testing.assert_array_equal(A.imag, stack[1])


@pytest.mark.parametrize("path", ["dft", "fft", "sym3", "general"])
def test_diversity_measurements_match_jax(path):
    """Each route of the measurement dispatch, column-major vector
    included: "dft" (total phases through B3's plain version), "fft"
    (full FFT and crop), "sym3" (B1) and "general" (B2), against the JAX
    dispatch -- its Pallas kernels in interpret mode for sym3/general,
    its jnp paths for dft/fft.  float32 DFTs summed in another order:
    rtol 2e-4 (tests/test_pallas.py) with atol 2e-4 of a unit-peak PSF
    for the dark pixels."""
    R, c, B = 64, 9, 3
    rng = np.random.default_rng(4)
    phase = rng.normal(size=(B, R, R)).astype(np.float32) * 0.4
    div = np.stack([-2.0, 0.0, 2.0])[:, None, None] * rng.normal(
        size=(R, R)).astype(np.float32) * 0.5
    div = div.astype(np.float32)
    scale = 1.0 / float(jpsf.pupil_mask_np(R).sum()) ** 2
    fused = path in ("sym3", "general")
    jkw, kw = {}, {}
    if path != "fft":
        jkw["dft_op"] = jdft.centered_partial_dft(R, c)
        kw["dft_op"] = dft.centered_partial_dft(R, c, device="cpu")
    if fused:
        jkw.update(use_pallas=True, pallas_interpret=True,
                   div_cos=jnp.cos(div), div_sin=jnp.sin(div),
                   div_sym3=path == "sym3")
        kw.update(div_cos=torch.cos(t32(div)), div_sin=torch.sin(t32(div)),
                  div_sym3=path == "sym3")
    want = jpsf.diversity_measurements(jnp.asarray(phase), jnp.asarray(div),
                                       jpsf.pupil_mask(R), scale, c, **jkw)
    got = psf.diversity_measurements(
        t32(phase), t32(div), psf.pupil_mask(R, device="cpu"), scale, c,
        **kw)
    assert got.shape == (B, 3 * (2 * c + 1) ** 2)
    np.testing.assert_allclose(npy(got), np.asarray(want), rtol=2e-4,
                               atol=2e-4)


def test_measurement_vector_is_column_major():
    crops = torch.arange(2 * 3 * 2 * 2, dtype=torch.float32).reshape(
        2, 3, 2, 2)
    y = psf.measurement_vector(crops)
    # each crop [[a, b], [c, d]] flattens as a, c, b, d (MATLAB reshape)
    assert y[0, :4].tolist() == [0.0, 2.0, 1.0, 3.0]
    np.testing.assert_array_equal(
        npy(y), np.asarray(jpsf.measurement_vector(jnp.asarray(npy(crops)))))


# --------------------------------------------------------------- kernel B1

def _b1_inputs(R=64, c=9, B=4, a=3.0, seed=1):
    rng = np.random.default_rng(seed)
    phase = (rng.normal(size=(B, R, R)) * 0.4).astype(np.float32)
    zmap = (rng.normal(size=(R, R)) * 0.5).astype(np.float32)
    return phase, zmap, a, c


def test_b1_plain_matches_jax_kernel_interpret():
    """psf_crop_diversity_sym3_ref == the Pallas sym3 kernel (interpret
    mode) at R=64, c=9, B=4, a=3: rtol 2e-4, atol 2e-4 (the tolerance of
    tests/test_pallas.py for the same kernel)."""
    phase, zmap, a, c = _b1_inputs()
    R = phase.shape[-1]
    cos_a = np.cos(a * zmap).astype(np.float32)
    sin_a = np.sin(a * zmap).astype(np.float32)
    want = jpk.psf_crop_diversity_sym3(
        jnp.asarray(phase), jpsf.pupil_mask(R), jnp.asarray(cos_a),
        jnp.asarray(sin_a), jdft.centered_partial_dft(R, c), 2.0,
        interpret=True)
    got = psf_kernels.psf_crop_diversity_sym3_ref(
        t32(phase), psf.pupil_mask(R, device="cpu"), t32(cos_a),
        t32(sin_a), dft.centered_partial_dft(R, c, device="cpu"), 2.0)
    assert got.shape == (4, 3, 2 * c + 1, 2 * c + 1)
    np.testing.assert_allclose(npy(got), np.asarray(want), rtol=2e-4,
                               atol=2e-4)


def _tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """float32 to the nearest TF32, ties away from zero, as
    cvt.rna.tf32.f32: add half of the 13 dropped bits, then drop them."""
    return ((x.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def _mm_tf32(a: torch.Tensor, b: torch.Tensor, passes: int) -> torch.Tensor:
    """a @ b as B1's tensor cores take it: each float32 operand split
    into TF32 hi = rna(x) and lo = rna(x - hi); 3 passes lo*hi + hi*lo +
    hi*hi (1 pass: hi*hi), each product exact in float32 and summed in
    float32."""
    a_hi, b_hi = _tf32_rna(a), _tf32_rna(b)
    if passes == 1:
        return a_hi @ b_hi
    a_lo, b_lo = _tf32_rna(a - a_hi), _tf32_rna(b - b_hi)
    return a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi


def _crops_tf32(fre, fim, dft_op, scale, passes=3):
    """The tensor-core engine that kernels B1-B4 ran before the wgmma
    engine (csrc/psf_mma.cuh, mma.sync; retired, last held by commit
    19f54fa) on the CPU: fields (..., R, R) formed in float32, then both
    complex DFT stages as real products through ``_mm_tf32``.  Each
    field's arithmetic is its own, whatever block it shares with two
    others.  Kept as the record of how C.3's float32 limits were set."""
    are, aim = dft_op.real.contiguous(), dft_op.imag.contiguous()

    def mm(a, b):
        return _mm_tf32(a, b, passes)
    gre = mm(are, fre) - mm(aim, fim)                          # (...,w,R)
    gim = mm(aim, fre) + mm(are, fim)
    ore = mm(gre, are.T) - mm(gim, aim.T)                      # (...,w,w)
    oim = mm(gre, aim.T) + mm(gim, are.T)
    return (ore ** 2 + oim ** 2) * scale


def _rtz_f32(x: torch.Tensor) -> torch.Tensor:
    """float64 ``x`` to float32, rounded toward zero."""
    y = x.float()
    return torch.where(y.double().abs() > x.abs(),
                       torch.nextafter(y, torch.zeros_like(y)), y)


def _mm_bf16_rtz(pairs, rtz=True) -> torch.Tensor:
    """sum of a @ b over (a, b) in ``pairs`` (bf16 values in float32, the
    same K) as the retired mma.sync engine's bf16 stage 1 took it (last
    held by commit 19f54fa): one
    mma.sync.m16n8k16 a pair and k16 slice, in the engine's order (each
    slice, then each pair), each adding its 16 exact products to the
    float32 accumulator and rounding the sum toward zero -- the tensor
    cores' accumulation, modelled; ``rtz=False`` rounds to nearest."""
    c = None
    for k0 in range(0, pairs[0][0].shape[-1], 16):
        for a, b in pairs:
            part = a[..., k0:k0 + 16].double() @ b[..., k0:k0 + 16, :].double()
            part = part if c is None else c.double() + part
            c = _rtz_f32(part) if rtz else part.float()
    return c


def _crops_bf16_rtz(fre, fim, dft_op, scale, rtz=True):
    """The retired engine's bf16 arithmetic (csrc/psf_mma.cuh,
    Precision::kBf16; last held by commit 19f54fa) on the CPU for fields
    without recombination (B2, B3), the record of how the smoke's bf16
    limits were set: the plain
    version's rounding points (psf_kernels._intensity_bf16), stage 1
    through ``_mm_bf16_rtz``.  Stage 2 stays float32: no bf16 rounding
    follows its sums, so how they round moves a pixel by float32 error
    alone."""
    bf = psf_kernels._bf16
    are, aim = bf(dft_op.real), bf(dft_op.imag)
    fre, fim = bf(fre), bf(fim)
    gre = bf(_mm_bf16_rtz([(are, fre), (aim, -fim)], rtz))
    gim = bf(_mm_bf16_rtz([(aim, fre), (are, fim)], rtz))
    ore = gre @ are.T - gim @ aim.T
    oim = gre @ aim.T + gim @ are.T
    return (ore ** 2 + oim ** 2) * scale


def _engine_case(kernel):
    """(kernel's arithmetic emulated, JAX kernel in interpret mode, plain
    version) at R=64, c=9: B1 on B=4 (a=3, scale 2); B2 on B=4 with the
    symmetric triple (the loop's ``div_sym3=False`` route) or 5 random
    maps; B3 on N=5 total phases (not a multiple of the engine's three
    fields a block); B2 and B3 at a unit-peak scale.  Each kernel's
    fields as it forms them: B1 by angle addition from pupil cos/sin of
    a Z, B2 by angle addition from each map's pupil cos/sin (formed by
    its wrapper), B3 as pupil (cos, sin) of each total phase."""
    phase, zmap, a, c = _b1_inputs()
    R = phase.shape[-1]
    pupil = psf.pupil_mask(R, device="cpu")
    op = dft.centered_partial_dft(R, c, device="cpu")
    jop, jpupil = jdft.centered_partial_dft(R, c), jpsf.pupil_mask(R)
    if kernel == "b1":
        cos_a = np.cos(a * zmap).astype(np.float32)
        sin_a = np.sin(a * zmap).astype(np.float32)
        args = (t32(phase), pupil, t32(cos_a), t32(sin_a), op, 2.0)
        cp, sp = torch.cos(args[0]), torch.sin(args[0])
        pcd, psd = pupil * args[2], pupil * args[3]
        t1, t2, t3, t4 = cp * pcd, sp * psd, sp * pcd, cp * psd
        fre = torch.stack([t1 + t2, pupil * cp, t1 - t2], dim=1)
        fim = torch.stack([t3 - t4, pupil * sp, t3 + t4], dim=1)
        want = jpk.psf_crop_diversity_sym3(
            jnp.asarray(phase), jpupil, jnp.asarray(cos_a),
            jnp.asarray(sin_a), jop, 2.0, interpret=True)
        plain = psf_kernels.psf_crop_diversity_sym3_ref(*args)
        return _crops_tf32(fre, fim, op, 2.0), want, plain
    scale = _unit_scale(R)
    if kernel == "b3":
        total = (np.random.default_rng(12).normal(size=(5, R, R))
                 * 0.4).astype(np.float32)
        args = (t32(total), pupil, op, scale)
        fre = pupil * torch.cos(args[0])
        fim = pupil * torch.sin(args[0])
        want = jpk.psf_crop_intensity(jnp.asarray(total), jpupil, jop, scale,
                                      interpret=True)
        plain = psf_kernels.psf_crop_intensity_ref(*args)
        return _crops_tf32(fre, fim, op, scale), want, plain
    n_div = int(kernel[-1])
    if n_div == 3:
        div = np.stack([-a * zmap, 0.0 * zmap, a * zmap])
    else:
        div = np.random.default_rng(13).normal(size=(n_div, R, R)) * 0.8
    div_cos = np.cos(div).astype(np.float32)
    div_sin = np.sin(div).astype(np.float32)
    args = (t32(phase), pupil, t32(div_cos), t32(div_sin), op, scale)
    cp, sp = torch.cos(args[0])[:, None], torch.sin(args[0])[:, None]
    pcd, psd = pupil * args[2], pupil * args[3]
    fre, fim = cp * pcd - sp * psd, sp * pcd + cp * psd
    want = jpk.psf_crop_diversity(
        jnp.asarray(phase), jpupil, jnp.asarray(div_cos),
        jnp.asarray(div_sin), jop, scale, interpret=True)
    plain = psf_kernels.psf_crop_diversity_ref(*args)
    return _crops_tf32(fre, fim, op, scale), want, plain


@pytest.mark.parametrize("kernel", ["b1", "b2_3", "b2_5", "b3"])
def test_b1_3xtf32_arithmetic_matches_jax_kernel_and_plain(kernel):
    """The retired mma.sync engine's 3xTF32 arithmetic (csrc/psf_mma.cuh,
    last held by commit 19f54fa), emulated here as the record of how
    C.3's float32 limits were set, on B1's fields as its old design
    formed them and on B2's and
    B3's (``_engine_case``) == the Pallas kernel each replaces (interpret
    mode) at that kernel's test tolerance (rtol 2e-4, atol 2e-4), and ==
    the float32 plain version at rtol 2e-4, atol 1e-5 of the peak.  The
    wgmma engine's designs of B1-B4 are emulated in
    tests/test_torch_b1_wgmma.py and tests/test_torch_wgmma_policies.py.

    For B1 against the float64 plain version at these inputs (on the
    CPU): 3 passes err 1.0e-7 of the peak (float32's plain version
    4.9e-7), one TF32 pass 1.0e-4 of the peak and up to 1.6e-2 relative
    on pixels above 1e-6 of the peak -- why the engine takes three."""
    got, want, plain = _engine_case(kernel)
    assert got.shape == plain.shape
    assert got.shape[-2:] == (19, 19)
    np.testing.assert_allclose(npy(got), np.asarray(want), rtol=2e-4,
                               atol=2e-4)
    peak = float(plain.abs().max())
    torch.testing.assert_close(got, plain, rtol=2e-4, atol=1e-5 * peak)


def test_b1_wrapper_takes_plain_version_on_cpu():
    """A CPU tensor runs the plain version and launches nothing."""
    phase, zmap, a, c = _b1_inputs(B=2)
    R = phase.shape[-1]
    args = (t32(phase), psf.pupil_mask(R, device="cpu"),
            t32(np.cos(a * zmap)), t32(np.sin(a * zmap)),
            dft.centered_partial_dft(R, c, device="cpu"), 2.0)
    before = psf_kernels.psf_crop_diversity_sym3.launches
    got = psf_kernels.psf_crop_diversity_sym3(*args)
    assert psf_kernels.psf_crop_diversity_sym3.launches == before
    torch.testing.assert_close(
        got, psf_kernels.psf_crop_diversity_sym3_ref(*args), rtol=0, atol=0)


def test_sym3_dispatch_matches_unfused_path():
    """diversity_measurements with div_cos/div_sin/div_sym3 (the B1 path)
    == the unfused DFT path on the same diversity stack: rtol/atol 2e-4
    as in tests/test_pallas.py."""
    phase, zmap, a, c = _b1_inputs(B=3, seed=5)
    R = phase.shape[-1]
    div = t32(np.stack([-a * zmap, 0.0 * zmap, a * zmap]))
    op = dft.centered_partial_dft(R, c, device="cpu")
    pupil = psf.pupil_mask(R, device="cpu")
    fused = psf.diversity_measurements(
        t32(phase), div, pupil, 2.0, c, dft_op=op,
        div_cos=torch.cos(div), div_sin=torch.sin(div), div_sym3=True)
    plain = psf.diversity_measurements(t32(phase), div, pupil, 2.0, c,
                                       dft_op=op)
    np.testing.assert_allclose(npy(fused), npy(plain), rtol=2e-4, atol=2e-4)


# --------------------------------------------------------- kernels B2-B4

def _unit_scale(R):
    """PSF scale that puts the diffraction-limited peak at ~1."""
    return 1.0 / float(jpsf.pupil_mask_np(R).sum()) ** 2


@pytest.mark.parametrize("n_div", [3, 5])
def test_b2_plain_matches_jax_kernel_interpret(n_div):
    """psf_crop_diversity_ref == the Pallas general kernel (interpret
    mode) on random 3- and 5-map stacks at R=64, c=9, B=3: rtol 2e-4,
    atol 2e-4 of the unit-peak PSF (tests/test_pallas.py)."""
    R, c, B = 64, 9, 3
    rng = np.random.default_rng(10 + n_div)
    phase = (rng.normal(size=(B, R, R)) * 0.4).astype(np.float32)
    div = (rng.normal(size=(n_div, R, R)) * 0.8).astype(np.float32)
    scale = _unit_scale(R)
    want = jpk.psf_crop_diversity(
        jnp.asarray(phase), jpsf.pupil_mask(R), jnp.cos(div), jnp.sin(div),
        jdft.centered_partial_dft(R, c), scale, interpret=True)
    got = psf_kernels.psf_crop_diversity_ref(
        t32(phase), psf.pupil_mask(R, device="cpu"), torch.cos(t32(div)),
        torch.sin(t32(div)), dft.centered_partial_dft(R, c, device="cpu"),
        scale)
    assert got.shape == (B, n_div, 2 * c + 1, 2 * c + 1)
    np.testing.assert_allclose(npy(got), np.asarray(want), rtol=2e-4,
                               atol=2e-4)


def test_b3_plain_matches_jax_kernel_interpret():
    """psf_crop_intensity_ref == the Pallas one-field kernel (interpret
    mode) at R=64, half 7, N=5 (the shapes of tests/test_pallas.py):
    rtol 2e-4, atol 2e-4 of the unit-peak PSF."""
    R, half, N = 64, 7, 5
    rng = np.random.default_rng(0)
    phase = (rng.normal(size=(N, R, R)) * 0.4).astype(np.float32)
    scale = _unit_scale(R)
    want = jpk.psf_crop_intensity(
        jnp.asarray(phase), jpsf.pupil_mask(R),
        jdft.centered_partial_dft(R, half), scale, interpret=True)
    got = psf_kernels.psf_crop_intensity_ref(
        t32(phase), psf.pupil_mask(R, device="cpu"),
        dft.centered_partial_dft(R, half, device="cpu"), scale)
    assert got.shape == (N, 2 * half + 1, 2 * half + 1)
    np.testing.assert_allclose(npy(got), np.asarray(want), rtol=2e-4,
                               atol=2e-4)


def test_b4_plain_matches_jax_kernel_interpret():
    """psf_crop_diversity_sym3_thin_ref == the Pallas thin-row kernel
    (interpret mode) at R=64, c=9, B=4, a=3: rtol 2e-4, atol 2e-4 of the
    unit-peak PSF; and it is B1's function (B1's plain version, same
    tolerance)."""
    phase, zmap, a, c = _b1_inputs(seed=2)
    R = phase.shape[-1]
    scale = _unit_scale(R)
    cos_a = np.cos(a * zmap).astype(np.float32)
    sin_a = np.sin(a * zmap).astype(np.float32)
    want = jpk.psf_crop_diversity_sym3_thin(
        jnp.asarray(phase), jpsf.pupil_mask(R), jnp.asarray(cos_a),
        jnp.asarray(sin_a), jdft.centered_partial_dft(R, c), scale,
        interpret=True)
    args = (t32(phase), psf.pupil_mask(R, device="cpu"), t32(cos_a),
            t32(sin_a), dft.centered_partial_dft(R, c, device="cpu"), scale)
    got = psf_kernels.psf_crop_diversity_sym3_thin_ref(*args)
    assert got.shape == (4, 3, 2 * c + 1, 2 * c + 1)
    np.testing.assert_allclose(npy(got), np.asarray(want), rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_allclose(
        npy(got), npy(psf_kernels.psf_crop_diversity_sym3_ref(*args)),
        rtol=2e-4, atol=2e-4)


def _wrapper_case(kernel):
    """(wrapper, plain version, CPU arguments) of kernel B1, B2, B3 or
    B4."""
    phase, zmap, a, c = _b1_inputs(B=2)
    R = phase.shape[-1]
    pupil = psf.pupil_mask(R, device="cpu")
    op = dft.centered_partial_dft(R, c, device="cpu")
    k = psf_kernels
    if kernel == "b1":
        return (k.psf_crop_diversity_sym3, k.psf_crop_diversity_sym3_ref,
                (t32(phase), pupil, t32(np.cos(a * zmap)),
                 t32(np.sin(a * zmap)), op, 2.0))
    if kernel == "b2":
        div = t32(np.stack([-a * zmap, 0.0 * zmap, a * zmap, 0.5 * zmap]))
        return (k.psf_crop_diversity, k.psf_crop_diversity_ref,
                (t32(phase), pupil, torch.cos(div), torch.sin(div), op, 2.0))
    if kernel == "b3":
        return (k.psf_crop_intensity, k.psf_crop_intensity_ref,
                (t32(phase), pupil, op, 2.0))
    return (k.psf_crop_diversity_sym3_thin,
            k.psf_crop_diversity_sym3_thin_ref,
            (t32(phase), pupil, t32(np.cos(a * zmap)),
             t32(np.sin(a * zmap)), op, 2.0))


@pytest.mark.parametrize("kernel", ["b2", "b3", "b4"])
def test_wrapper_takes_plain_version_on_cpu(kernel):
    """A CPU tensor runs the plain version and launches nothing; a tensor
    on neither the CPU nor a CUDA device is refused, not rerouted."""
    wrapper, plain, args = _wrapper_case(kernel)
    before = wrapper.launches
    got = wrapper(*args)
    assert wrapper.launches == before
    torch.testing.assert_close(got, plain(*args), rtol=0, atol=0)
    with pytest.raises(ValueError, match="CUDA tensors"):
        wrapper(args[0].to("meta"), *args[1:])
    assert wrapper.launches == before


# ------------------------------------------------- bf16 branch of B1-B3

def _bf16_case(kernel):
    """(the Pallas kernel's compute_dtype="bfloat16" branch in interpret
    mode, the plain version with compute_dtype="bfloat16", the float32
    plain version) at R=64, c=9, unit-peak scale: B1 and B4 on B=4 (a=3);
    B2 on B=4 with the symmetric triple ("b2_3") or 1 or 5 random maps; B3
    on N=5 total phases."""
    phase, zmap, a, c = _b1_inputs()
    R = phase.shape[-1]
    pupil = psf.pupil_mask(R, device="cpu")
    op = dft.centered_partial_dft(R, c, device="cpu")
    jop, jpupil = jdft.centered_partial_dft(R, c), jpsf.pupil_mask(R)
    scale = _unit_scale(R)
    bf16 = dict(interpret=True, compute_dtype="bfloat16")
    k = psf_kernels
    if kernel in ("b1", "b4"):
        cos_a = np.cos(a * zmap).astype(np.float32)
        sin_a = np.sin(a * zmap).astype(np.float32)
        jax_kernel, plain = {
            "b1": (jpk.psf_crop_diversity_sym3,
                   k.psf_crop_diversity_sym3_ref),
            "b4": (jpk.psf_crop_diversity_sym3_thin,
                   k.psf_crop_diversity_sym3_thin_ref)}[kernel]
        want = jax_kernel(jnp.asarray(phase), jpupil, jnp.asarray(cos_a),
                          jnp.asarray(sin_a), jop, scale, **bf16)
        args = (t32(phase), pupil, t32(cos_a), t32(sin_a), op, scale)
    elif kernel == "b3":
        total = (np.random.default_rng(12).normal(size=(5, R, R))
                 * 0.4).astype(np.float32)
        want = jpk.psf_crop_intensity(jnp.asarray(total), jpupil, jop,
                                      scale, **bf16)
        plain, args = k.psf_crop_intensity_ref, (t32(total), pupil, op,
                                                 scale)
    else:
        n_div = int(kernel[-1])
        if n_div == 3:
            div = np.stack([-a * zmap, 0.0 * zmap, a * zmap])
        else:
            div = np.random.default_rng(13).normal(size=(n_div, R, R)) * 0.8
        div_cos = np.cos(div).astype(np.float32)
        div_sin = np.sin(div).astype(np.float32)
        want = jpk.psf_crop_diversity(
            jnp.asarray(phase), jpupil, jnp.asarray(div_cos),
            jnp.asarray(div_sin), jop, scale, **bf16)
        plain = k.psf_crop_diversity_ref
        args = (t32(phase), pupil, t32(div_cos), t32(div_sin), op, scale)
    return (np.asarray(want), plain(*args, compute_dtype="bfloat16"),
            plain(*args))


@pytest.mark.parametrize("kernel", ["b1", "b2_3", "b2_1", "b2_5", "b3",
                                    "b4"])
def test_bf16_plain_matches_jax_kernel_branch(kernel):
    """Each plain version with compute_dtype="bfloat16" rounds where its
    Pallas kernel's bf16 branch rounds: == that branch (interpret mode)
    at rtol 2e-4, atol 1e-5 of the peak -- float32 sums in another order
    (6.5e-8 of the peak here); rounding B1's +- fields instead of its four
    products misses by 8.1e-5.  And the branch really rounds: it differs
    from the float32 plain version by more than 10x that atol (3.2e-4 to
    9.5e-4 of the peak here)."""
    want, got, f32 = _bf16_case(kernel)
    assert got.shape == want.shape == f32.shape
    assert got.shape[-2:] == (19, 19)
    peak = float(np.abs(want).max())
    np.testing.assert_allclose(npy(got), want, rtol=2e-4, atol=1e-5 * peak)
    assert float((got - f32).abs().max()) > 10 * 1e-5 * peak


@pytest.mark.parametrize("dtype", [None, "bfloat16"])
@pytest.mark.parametrize("w", [41, 63])
@pytest.mark.parametrize("kernel", ["b1", "b2", "b3", "b4"])
def test_plain_versions_match_jax_kernels_at_wide_crops(kernel, w, dtype):
    """B1-B4's plain versions == their Pallas kernels (interpret mode) at
    crops wider than one 32-px band of the CUDA engine, w = 41 and 63 at
    R=64, B=2 (B2 on the symmetric triple, B3 on its 6 total phases), in
    float32 and in the bf16 branch, unit-peak scale: rtol 2e-4 and atol
    2e-4 of the peak in float32 (tests/test_pallas.py), 1e-5 of the peak
    in bf16 (``test_bf16_plain_matches_jax_kernel_branch``)."""
    phase, zmap, a, _ = _b1_inputs(B=2, seed=3)
    R, c = phase.shape[-1], (w - 1) // 2
    scale = _unit_scale(R)
    triple = np.stack([-a * zmap, 0.0 * zmap, a * zmap])
    pupil, jpupil = psf.pupil_mask(R, device="cpu"), jpsf.pupil_mask(R)
    op, jop = (dft.centered_partial_dft(R, c, device="cpu"),
               jdft.centered_partial_dft(R, c))
    k = psf_kernels
    if kernel == "b3":
        total = (phase[:, None] + triple).reshape(-1, R, R).astype(np.float32)
        jax_args, args = (total,), (t32(total),)
        jax_kernel, plain = jpk.psf_crop_intensity, k.psf_crop_intensity_ref
    else:
        maps = ((np.cos(triple), np.sin(triple)) if kernel == "b2" else
                (np.cos(a * zmap), np.sin(a * zmap)))
        maps = [m.astype(np.float32) for m in maps]
        jax_args, args = (phase, *maps), (t32(phase), *map(t32, maps))
        jax_kernel, plain = {
            "b1": (jpk.psf_crop_diversity_sym3,
                   k.psf_crop_diversity_sym3_ref),
            "b2": (jpk.psf_crop_diversity, k.psf_crop_diversity_ref),
            "b4": (jpk.psf_crop_diversity_sym3_thin,
                   k.psf_crop_diversity_sym3_thin_ref)}[kernel]
    jax_args = [jnp.asarray(x) for x in jax_args]
    want = np.asarray(jax_kernel(jax_args[0], jpupil, *jax_args[1:], jop,
                                 scale, interpret=True,
                                 compute_dtype=dtype))
    got = npy(plain(args[0], pupil, *args[1:], op, scale,
                    compute_dtype=dtype))
    assert got.shape == want.shape and got.shape[-2:] == (w, w)
    peak = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=2e-4,
                               atol=(1e-5 if dtype else 2e-4) * peak)


def test_operator_scratch_holds_every_crop_band():
    """The kernels lay the operator out in ceil(w / 32) bands of 32 rows.
    The largest layout is the float32 entries' 3xTF32 image on the wgmma
    engine: a band's 64 stacked rows in TF32 hi and lo, once for stage 1
    and once for stage 2, 256 floats a row of R rounded up to 32; the
    bf16 entries' image takes less.  The wrapper's scratch holds every
    band: one up to w = 32 and two at w = 33 and 63."""
    tile = 256 * 32
    assert psf_kernels._operator_scratch(128, 31) == tile * 4
    assert psf_kernels._operator_scratch(100, 32) == tile * 4
    for w in (33, 63):
        assert psf_kernels._operator_scratch(64, w) == tile * 2 * 2
    assert psf_kernels._operator_scratch(512, 63) == tile * 16 * 2
    assert psf_kernels._operator_scratch(64, 65) == tile * 2 * 3


def test_port_imports_neither_jax_nor_the_jax_package():
    """No module of mpc_sensorlessao_tpu_torch, nor chip_smoke.py, imports
    jax or mpc_sensorlessao_tpu (the port runs where neither exists)."""
    root = Path(__file__).resolve().parents[1]
    files = sorted((root / "mpc_sensorlessao_tpu_torch").rglob("*.py"))
    files.append(root / "chip_smoke.py")
    assert len(files) > 30
    banned = ("jax", "jaxlib", "mpc_sensorlessao_tpu")
    for f in files:
        for node in ast.walk(ast.parse(f.read_text(), str(f))):
            if isinstance(node, ast.Import):
                names = [alias.name for alias in node.names]
            elif isinstance(node, ast.ImportFrom) and not node.level:
                names = [node.module]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in banned, (str(f), name)


def _chip_smoke():
    """chip_smoke.py, imported as a module (its main does not run)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _smoke_scenario(j: int, R: int) -> torch.Tensor:
    """Scenario j's phase (1, R, R) of chip_smoke.b1_args(R, B > j): its
    generator's draws in 512-scenario chunks up to j, then j's."""
    rng = np.random.default_rng(0)
    for lo in range(0, j, 512):
        rng.normal(size=(min(512, j - lo), R, R))
    return t32(rng.normal(size=(1, R, R)) * 0.4)


def test_bf16_card_limit_catches_misrounded_b1():
    """chip_smoke.py's bf16 limit for B1 (BF16_ATOL, of the peak) catches
    a B1 kernel that rounds its +- fields instead of its four products,
    on the smoke's inputs at R=128 (real diversity; its first 16
    scenarios): such a kernel computes B2's bf16 function on the triple
    (B2's bf16 plain version rounds each field), which misses B1's bf16
    plain output by 6.5e-5 of the peak here, above the 4e-5 limit; the
    card's B1 reads 1.03e-5 at B=4096 (PERF.md)."""
    smoke = _chip_smoke()
    cases = {label: args for label, _, args, _ in
             smoke.kernel_cases(128, 16, "cpu")}
    b1 = psf_kernels.psf_crop_diversity_sym3_ref(*cases["B1"],
                                                 compute_dtype="bfloat16")
    fields = psf_kernels.psf_crop_diversity_ref(*cases["B2 (3 maps)"],
                                                compute_dtype="bfloat16")
    peak = float(b1.abs().max())
    assert smoke.BF16_ATOL == 4e-5
    assert float((fields - b1).abs().max()) > 1.5 * smoke.BF16_ATOL * peak


@pytest.mark.parametrize("label,scenario,card_err", [
    ("B2 (3 maps)", 1461, 1.157e-3), ("B2 (5 random maps)", 4073, 3.820e-3)])
def test_bf16_rtz_emulation_reproduces_card_reading(label, scenario,
                                                    card_err):
    """The engine's bf16 stage-1 sums rounded toward zero
    (``_crops_bf16_rtz``) reproduce the reading of B2's bf16 entry on
    that engine (psf_mma.cuh, before it moved to psf_wgmma.cuh; the
    engine is retired, last held by commit 19f54fa) on the card in
    chip_smoke.py's kernel phase at R=128, B=4096 -- max abs error
    1.157e-3 on the triple, 3.820e-3 on the 5 random maps (NVIDIA H100
    80GB HBM3, 700 W) -- in the one scenario where the emulation errs
    most over that batch: one bf16 rounding of a stage-1 element flips.
    That is 1.9e-5 of the peak on the triple, within the smoke's
    BF16_ATOL, and 1.18e-4 on the random maps' speckle, above 1e-4 and
    within BF16_ATOL_RANDOM_MAPS.  The same sums rounded to nearest give
    the plain version to 2e-8 of the peak: the rounding mode is the
    cause, not the order."""
    smoke = _chip_smoke()
    _, pupil, div_cos, div_sin, op, scale = {
        lbl: args for lbl, _, args, _ in smoke.kernel_cases(128, 1, "cpu")
    }[label]
    phase = _smoke_scenario(scenario, 128)
    c, s = torch.cos(phase)[:, None], torch.sin(phase)[:, None]
    fre = pupil * (c * div_cos - s * div_sin)
    fim = pupil * (s * div_cos + c * div_sin)
    want = psf_kernels.psf_crop_diversity_ref(
        phase, pupil, div_cos, div_sin, op, scale, compute_dtype="bfloat16")
    peak = float(want.abs().max())
    err = float((_crops_bf16_rtz(fre, fim, op, scale) - want).abs().max())
    assert err == pytest.approx(card_err, rel=0.01)
    if label == "B2 (3 maps)":
        assert err <= smoke.BF16_ATOL * peak
    else:
        assert 1e-4 * peak < err <= smoke.BF16_ATOL_RANDOM_MAPS * peak
    nearest = _crops_bf16_rtz(fre, fim, op, scale, rtz=False)
    assert float((nearest - want).abs().max()) <= 1e-7 * peak


@pytest.mark.parametrize("kernel", ["b1", "b2", "b3", "b4"])
def test_wrapper_takes_bf16_plain_version_on_cpu(kernel):
    """compute_dtype="bfloat16" on a CPU tensor runs the plain version's
    bf16 branch and counts no launch of either kernel; on a tensor on
    neither the CPU nor a CUDA device it is refused, not rerouted; an
    unknown compute_dtype raises."""
    wrapper, plain, args = _wrapper_case(kernel)
    before = (wrapper.launches, wrapper.launches_bf16)
    got = wrapper(*args, compute_dtype="bfloat16")
    torch.testing.assert_close(got, plain(*args, compute_dtype="bfloat16"),
                               rtol=0, atol=0)
    with pytest.raises(ValueError, match="CUDA tensors"):
        wrapper(args[0].to("meta"), *args[1:], compute_dtype="bfloat16")
    with pytest.raises(ValueError, match="compute_dtype"):
        wrapper(*args, compute_dtype="float16")
    assert (wrapper.launches, wrapper.launches_bf16) == before


def test_b4_refuses_bfloat16():
    """Kernel B4's wrapper dispatches compute_dtype="bfloat16" as B1-B3's
    do: on a CPU tensor to its plain version's bf16 branch, with no launch
    counted; on a meta tensor (neither the CPU nor a CUDA device) it is
    refused before any launch, in either precision; and it refuses a
    compute_dtype it has no branch for ("float16"), on the CPU and before
    any launch."""
    wrapper, plain, args = _wrapper_case("b4")
    before = (wrapper.launches, wrapper.launches_bf16)
    torch.testing.assert_close(wrapper(*args, compute_dtype="bfloat16"),
                               plain(*args, compute_dtype="bfloat16"),
                               rtol=0, atol=0)
    for dtype in (None, "bfloat16"):
        with pytest.raises(ValueError, match="CUDA tensors"):
            wrapper(args[0].to("meta"), *args[1:], compute_dtype=dtype)
    for fn, phase in ((wrapper, args[0]), (plain, args[0]),
                      (wrapper, args[0].to("meta"))):
        with pytest.raises(ValueError, match="compute_dtype"):
            fn(phase, *args[1:], compute_dtype="float16")
    assert (wrapper.launches, wrapper.launches_bf16) == before


@pytest.mark.parametrize("route", ["sym3", "general", "unfused"])
def test_estimator_carries_dft_dtype(route):
    """estimator.build carries EstimatorConfig.dft_dtype="bfloat16",
    with_route keeps it, and measure takes the route's bf16 branch:
    exactly diversity_measurements with compute_dtype="bfloat16", not the
    float32 measure.  An unknown dft_dtype raises ValueError at build
    and in the model."""
    cfg = reference_config(resolution=32)
    basis = zernike.make_basis(6, 32, device="cpu")
    model = estimator.with_route(estimator.build(
        dataclasses.replace(cfg.estimator, dft_dtype="bfloat16"), basis,
        device="cpu"), route)
    assert model.dft_dtype == "bfloat16"
    phase = t32(np.random.default_rng(14).normal(size=(2, 32, 32)) * 0.3)
    want = psf.diversity_measurements(
        phase, model.diversity_phases, model.pupil, model.scale,
        model.crop_half, dft_op=model.dft_op, div_cos=model.div_cos,
        div_sin=model.div_sin, div_sym3=model.div_sym3,
        compute_dtype="bfloat16")
    got = estimator.measure(model, phase)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    f32 = estimator.measure(dataclasses.replace(model, dft_dtype="float32"),
                            phase)
    assert not torch.equal(got, f32)
    with pytest.raises(ValueError, match="dft_dtype"):
        estimator.build(dataclasses.replace(cfg.estimator,
                                            dft_dtype="float16"),
                        basis, device="cpu")
    with pytest.raises(ValueError, match="dft_dtype"):
        dataclasses.replace(model, dft_dtype="float16")


def test_kernel_variants_agree_on_cpu():
    """The kernel A/B's variants (benchmarks/kernel_variants.py) on CPU
    tensors -- their wrappers take the plain versions -- measure the
    same crops of the JAX script's inputs, at R=64, B=2: the four float32
    variants, and B1-B3's three bf16 branches among themselves, each
    against its precision's ``general``: rtol 2e-4, atol 2e-4 of the
    peak."""
    inp = kernel_variants.inputs(64, 2, "cpu")
    out = {name: fn() for name, fn in kernel_variants.variants(inp).items()}
    assert set(out) == set(kernel_variants.VARIANTS
                           + kernel_variants.BF16_VARIANTS)
    for name, got in out.items():
        base, dtype = kernel_variants.precision(name)
        want = out["general" + ("_bf16" if dtype else "")]
        assert want.shape == (2, 3, kernel_variants.CROP,
                              kernel_variants.CROP)
        torch.testing.assert_close(got, want, rtol=2e-4,
                                   atol=2e-4 * float(want.max()), msg=name)


@pytest.mark.parametrize("builder", [
    "pipeline", "make_scenarios", "estimator", "dm", "make_layers",
    "make_basis", "centered_partial_dft", "pupil_mask",
    "pipeline_conditional", "edge_flow", "batch_states",
    "extension_operators", "scenario_mesh", "tp_mesh", "hz_mesh", "spawn",
    "dryrun_multichip", "multihost_main", "montecarlo_100k",
    "multiprocess", "wfs", "pyramid", "karhunen_loeve", "gaussian_frame",
    "classical_row", "classical_vs_mpc", "toeplitz", "slopes_mmse",
    "slopes_tomography", "slopes_lgs", "lgs", "tomography", "mcao",
    "wfs_demo", "mcao_demo", "closed_loop_demo", "horizon_sweep_demo",
    "full_protocol", "protocol_sweep", "montecarlo_sweep", "modes_horizon",
    "protocol_edge", "excursion_tail", "latency_b1", "solver_throughput",
    "long_horizon", "cholesky_paths", "bench", "step_breakdown",
    "step_knockouts", "edge_flow_cost", "edge_flow_breakdown", "scaling",
    "oracle_reference_rows"])
def test_builders_default_to_the_card(builder, monkeypatch):
    """Every builder runs on the card unless the caller passes "cpu":
    without a CUDA device, a call that names no device raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = reference_config(resolution=32)
    basis = zernike.make_basis(6, 32, device="cpu")
    tel = dataclasses.replace(cfg.telescope, resolution=32)
    calls = {
        "pipeline": lambda: pipeline.build(cfg),
        "make_scenarios": lambda: montecarlo.make_scenarios(
            cfg, torch.Generator().manual_seed(0), 2),
        "estimator": lambda: estimator.build(cfg.estimator, basis),
        "dm": lambda: dm.build(cfg.dm, basis),
        "make_layers": lambda: phase_screens.make_layers(3, cfg.atmosphere,
                                                         tel),
        "make_basis": lambda: zernike.make_basis(6, 32),
        "centered_partial_dft": lambda: dft.centered_partial_dft(32, 7),
        "pupil_mask": lambda: psf.pupil_mask(32),
        "pipeline_conditional": lambda: pipeline.build(cfg.replace(
            atmosphere=dataclasses.replace(cfg.atmosphere,
                                           flow="conditional"))),
        "edge_flow": lambda: edge_flow.build(3, cfg.atmosphere, tel),
        "batch_states": lambda: edge_flow.batch_states(3, cfg.atmosphere,
                                                       tel, 2),
        "extension_operators": lambda: edge_flow.extension_operators(
            cfg.atmosphere.layer(0), 8, 1 / 7),
        "scenario_mesh": lambda: mesh.scenario_mesh(),
        "tp_mesh": lambda: estimator_tp.tp_mesh(),
        "hz_mesh": lambda: horizon.hz_mesh(),
        "spawn": lambda: multihost.spawn(dryrun.dryrun_rank, 2),
        "dryrun_multichip": lambda: dryrun.dryrun_multichip(2),
        "multihost_main": lambda: multihost.main([]),
        "montecarlo_100k": lambda: montecarlo_100k.main(
            ["32"], {"MC1_DR0": "5", "MC1_REPS": "2", "MC1_CHUNK": "2"}),
        "multiprocess": lambda: multiprocess.main([]),
        "wfs": lambda: wfs.build(32, n_lenslet=8),
        "pyramid": lambda: pyramid.build(16, 4),
        "karhunen_loeve": lambda: karhunen_loeve.make_basis(
            cfg.atmosphere, 1.0, 6, grid_basis=basis, resolution=16),
        "gaussian_frame": lambda: imaging.gaussian_frame(16, 3.0),
        "classical_row": lambda: classical_vs_mpc.row(
            classical_vs_mpc.row_cfg(32, 5.0, 2)),
        "classical_vs_mpc": lambda: classical_vs_mpc.main(
            ["32"], {"CVM_DR0": "5", "CVM_STEPS": "2"}),
        "toeplitz": lambda: toeplitz.build((2, 2), (2, 2), np.ones((3, 3))),
        "slopes_mmse": lambda: slopes_mmse.build(
            cfg.atmosphere, 1.0, 4, np.ones((4, 4), bool), 1.0, nf=64),
        "slopes_tomography": lambda: slopes_mmse.build_tomographic(
            cfg.atmosphere, 1.0, 4, np.ones((4, 4), bool), 1.0,
            [(0.0, 0.0), (1e-5, 0.0)], nf=64),
        "slopes_lgs": lambda: slopes_mmse.build_lgs(
            cfg.atmosphere, 1.0, 4, np.ones((4, 4), bool), 1.0, 90e3,
            nf=64),
        "lgs": lambda: lgs.build([89e3, 90e3, 91e3]),
        "tomography": lambda: tomography.build(cfg.atmosphere.layer(0), 1.0,
                                               1, [(0.0, 0.0)]),
        "mcao": lambda: mcao.build(cfg.atmosphere.layer(0), 1.0, 1e-4,
                                   [mcao.DMLayer(0.0, 1)], 1, [(0.0, 0.0)],
                                   resolution=16),
        "wfs_demo": lambda: wfs_demo.main(),
        "mcao_demo": lambda: mcao_demo.main(n_mc=2),
        "closed_loop_demo": lambda: closed_loop_demo.main(n_test=2),
        "horizon_sweep_demo": lambda: horizon_sweep_demo.main(n_test=2),
        "full_protocol": lambda: full_protocol.main(["32", "2"], {}),
        "protocol_sweep": lambda: protocol_sweep.main(["32"], {}),
        "montecarlo_sweep": lambda: montecarlo_sweep.main(["32"], {}),
        "modes_horizon": lambda: modes_horizon.main([], {}),
        "protocol_edge": lambda: protocol_edge.main(["32"], {}),
        "excursion_tail": lambda: excursion_tail.main(["32"], {}),
        "latency_b1": lambda: latency_b1.main([], {}),
        "solver_throughput": lambda: solver_throughput.main(["4"], {}),
        "long_horizon": lambda: long_horizon.main(["4"], {}),
        "cholesky_paths": lambda: cholesky_paths.main(["4"], {}),
        "bench": lambda: bench.main([], {"BENCH_RES": "32"}),
        "step_breakdown": lambda: step_breakdown.main(["32", "2", "2"], {}),
        "step_knockouts": lambda: step_knockouts.main(["32", "2", "2"], {}),
        "edge_flow_cost": lambda: edge_flow_cost.main(["32", "2"], {}),
        "edge_flow_breakdown": lambda: edge_flow_breakdown.main(
            [], {"EFB_RES": "32"}),
        "scaling": lambda: scaling.main(["2", "2"], {}),
        "oracle_reference_rows": lambda: oracle_reference_rows.main(
            [], {"ORACLE_RES": "32"}),
    }
    for var in ("MC1_DEVICE", "MP_DEVICE"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises((AssertionError, RuntimeError), match="CUDA|NVIDIA"):
        calls[builder]()


def test_estimator_build_refuses_wide_crops_on_cuda():
    """estimator.build takes any crop width, as the JAX estimator does:
    at crop_half=16 (33-px crops, two crop bands of the engine) a CUDA
    build is not refused for its width (here it fails only for want of a
    card), and the CPU build matches the JAX estimator's at the same
    width -- A_s and b_s to 1e-5 of their scale (tests/test_torch_loop.py)
    -- and so does its measure on random phases through the B1 plain
    version, against the JAX measure (the Pallas kernel's reference
    path): rtol 2e-4, atol 2e-4 of the peak."""
    cfg = reference_config(resolution=64)
    est_cfg = dataclasses.replace(cfg.estimator, crop_half=16)
    basis = zernike.make_basis(6, 64, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises((AssertionError, RuntimeError),
                           match="CUDA|NVIDIA"):
            estimator.build(est_cfg, basis, device="cuda")
    model = estimator.build(est_cfg, basis, device="cpu")
    theirs = jestimator.build(
        dataclasses.replace(jconfig.reference_config(resolution=64).estimator,
                            crop_half=16), jz.make_basis(6, 64))
    for name in ("A_s", "b_s"):
        want = np.asarray(getattr(theirs, name))
        got = npy(getattr(model, name))
        assert got.shape == want.shape, name
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-5 * np.abs(want).max(),
                                   err_msg=name)
    ph = (np.random.default_rng(15).normal(size=(2, 64, 64))
          * 0.3).astype(np.float32)
    want = np.asarray(jestimator.measure(theirs, jnp.asarray(ph)))
    got = npy(estimator.measure(model, t32(ph)))
    assert got.shape == want.shape == (2, 3 * 33 * 33)
    np.testing.assert_allclose(got, want, rtol=2e-4,
                               atol=2e-4 * np.abs(want).max())


def _telemetry(S, T, nu=5, nx=4, seed=20):
    """Seeded positive (S, T, ...) telemetry with StepOutputs' fields."""
    rng = np.random.default_rng(seed)
    wide = {"u": nu, "du": nu, "volts": nu, "x_est": nx}
    return [(rng.random((S, T, wide[f]) if f in wide else (S, T)) + 0.1)
            .astype(np.float32) for f in closed_loop.StepOutputs._fields]


@pytest.mark.parametrize("settle_fraction", [0.5, 0.3])
def test_summarize_matches_jax(settle_fraction):
    """metrics.summarize == the JAX summarize on the same (S, T, ...)
    telemetry, from step int(T * settle_fraction) on (the JAX function
    jitted with settle_fraction static, as a Python float): rtol 1e-6
    (float32 reductions in another order; the p95 by order statistics in
    both)."""
    arrays = _telemetry(3, 10)
    got = metrics.to_dict(metrics.summarize(
        closed_loop.StepOutputs(*map(t32, arrays)), settle_fraction))
    jsummarize = jax.jit(jmetrics.summarize.__wrapped__, static_argnums=1)
    want = jmetrics.to_dict(jsummarize(
        jcl.StepOutputs(*map(jnp.asarray, arrays)), settle_fraction))
    assert set(got) == set(want)
    for k in got:
        assert got[k] == pytest.approx(want[k], rel=1e-6), k


def test_summarize_p95_above_2_to_24_elements():
    """p95_rms_res over 2^24 + 1 settled samples -- where torch.quantile
    refuses its input -- == numpy.percentile (linear interpolation, as
    jnp.percentile): rtol 1e-6.  The other series share rms_res's
    storage, so the check holds ~70 MB."""
    n = 2 ** 24 + 1
    x = np.random.default_rng(21).random((1, n)).astype(np.float32)
    series = torch.as_tensor(x)
    small = torch.ones(1, 1, 1)
    fields = {f: small for f in closed_loop.StepOutputs._fields}
    fields.update(rms_res=series, rms_turb=series, strehl=series,
                  strehl_exact=series, cost=series)
    got = metrics.summarize(closed_loop.StepOutputs(**fields),
                            settle_fraction=0.0)
    assert float(got.p95_rms_res) == pytest.approx(
        float(np.percentile(x, 95)), rel=1e-6)


# ------------------------------------------------------------- turbulence

def _small_layers():
    cfg = reference_config(resolution=32)
    tel = dataclasses.replace(cfg.telescope, resolution=32)
    jcfg = jconfig.reference_config(resolution=32)
    jtel = dataclasses.replace(jcfg.telescope, resolution=32)
    return (phase_screens.make_layers(3, cfg.atmosphere, tel, device="cpu"),
            jps.make_layers(3, jcfg.atmosphere, jtel))


def test_screens_identical_to_jax():
    """Same host numpy code and seeds: bit-identical screens and steps."""
    ours, theirs = _small_layers()
    np.testing.assert_array_equal(npy(ours.screens),
                                  np.asarray(theirs.screens))
    np.testing.assert_array_equal(npy(ours.step_px),
                                  np.asarray(theirs.step_px))


@pytest.mark.parametrize("step", [0.0, 7.375, 350.0, 1234.6])
def test_phase_at_identical_to_jax(step):
    """Window offsets and tap weights are formed in float32 as in the JAX
    package.  The shared-window (host offset) path reproduces the JAX
    window to the bit; the batched gather path blends with tensor weights
    and may round the last of four products differently: atol 1 ulp of
    the screen scale (1e-6 rad)."""
    ours, theirs = _small_layers()
    want = np.asarray(jps.phase_at(theirs, jnp.float32(step), 32))
    got = npy(phase_screens.phase_at(ours, step, 32))
    np.testing.assert_array_equal(got, want)
    batched = npy(phase_screens.phase_at(
        ours, torch.tensor([step, step + 3.0]), 32))
    want2 = np.asarray(jps.phase_at(theirs, jnp.float32(step + 3.0), 32))
    np.testing.assert_allclose(batched[0], want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(batched[1], want2, rtol=0, atol=1e-6)


@pytest.mark.parametrize("steps", [[0.0, 7.375, 350.0],
                                   [-3.25, -0.5, 1e4 + 0.125],
                                   [1234.6]])
def test_piston_removed_phase_at_plain_is_phase_at_then_piston(steps):
    """On a CPU tensor kernel T1's entry point is the plain composition:
    phase_at at per-scenario steps (negative, fractional and past the
    screens' period), then piston_removed_phase_masked, to the bit."""
    ours, _ = _small_layers()
    b = zernike.make_basis(6, 32, device="cpu")
    npix = torch.tensor(float(b.mask.sum()))
    step = torch.tensor(steps, dtype=torch.float32)
    want = zernike.piston_removed_phase_masked(
        phase_screens.phase_at(ours, step, 32), b.mask, npix)
    before = phase_screens.piston_removed_phase_at.launches
    got = phase_screens.piston_removed_phase_at(ours, step, 32, b.mask, npix)
    assert phase_screens.piston_removed_phase_at.launches == before
    assert got.shape == (len(steps), 32, 32)
    np.testing.assert_array_equal(npy(got), npy(want))


def test_turbulence_rollout_matches_jax():
    """Open-loop Zernike series: float32 window sums and fit matmul in
    another order, rtol 1e-4 of the series scale."""
    from mpc_sensorlessao_tpu.models import closed_loop as jcl
    ours, theirs = _small_layers()
    jb = jz.make_basis(6, 32)
    b = zernike.make_basis(6, 32, device="cpu")
    npix = float(np.asarray(jb.mask).sum())
    want = np.asarray(jcl.turbulence_rollout(
        theirs, jb.fit_full, jb.mask, jnp.float32(npix), n_steps=40,
        resolution=32, start_step=5, mag=1.7))
    got = npy(closed_loop.turbulence_rollout(
        ours, b.fit_full, b.mask, torch.tensor(npix), n_steps=40,
        resolution=32, start_step=5, mag=1.7))
    assert got.shape == (40, 28)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * np.abs(want).max())


# -------------------------------------------------------------- DM, VAR

def test_dm_matches_jax():
    """Host float64 projection in both: equal to float32 rounding."""
    cfg = reference_config(resolution=32)
    ours = dm.build(cfg.dm, zernike.make_basis(6, 32, device="cpu"),
                    device="cpu")
    theirs = jdm.build(jconfig.reference_config(resolution=32).dm,
                       jz.make_basis(6, 32))
    np.testing.assert_allclose(npy(ours.influence),
                               np.asarray(theirs.influence), rtol=1e-5,
                               atol=1e-6)
    u = np.linspace(-3.0, 3.0, 13).astype(np.float32)
    np.testing.assert_allclose(
        npy(dm.rad_to_volts(t32(u), 0.047275, 2.709264, 84.67)),
        np.asarray(jdm.rad_to_volts(jnp.asarray(u), 0.047275, 2.709264,
                                    84.67)), rtol=1e-6, atol=1e-5)


def test_var_fit_matches_jax():
    """Same normal equations on a well-conditioned random VAR(2) series;
    float32 solves by different LAPACK paths: rtol 1e-3 of max|A|."""
    rng = np.random.default_rng(6)
    nx, T = 5, 400
    A1 = 0.5 * np.eye(nx) + 0.05 * rng.normal(size=(nx, nx))
    A2 = 0.2 * np.eye(nx)
    x = np.zeros((T, nx))
    for k in range(2, T):
        x[k] = A1 @ x[k - 1] + A2 @ x[k - 2] + rng.normal(size=nx)
    x = x.astype(np.float32)
    for ridge in (0.0, 0.1):
        ours = var.fit(t32(x), 2, ridge=ridge)
        theirs = jvar.fit(jnp.asarray(x), 2, ridge=ridge)
        want = np.asarray(theirs.A)
        np.testing.assert_allclose(npy(ours.A), want, rtol=0,
                                   atol=1e-3 * np.abs(want).max())
    unstable = var.VARModel(A=torch.tensor([[[1.2]], [[0.1]]]), order=2)
    stab = var.stabilize(unstable, 0.9)
    assert abs(var.companion_spectral_radius(stab) - 0.9) < 1e-5
    np.testing.assert_allclose(
        npy(stab.A),
        np.asarray(jvar.stabilize(jvar.VARModel(
            A=jnp.asarray(npy(unstable.A)), order=2), 0.9).A), rtol=1e-6)


# ---------------------------------------------------------- MPC, solvers

def _controller(seed=0, nx=6, nu=9, N=2):
    rng = np.random.default_rng(seed)
    A1 = (0.6 * np.eye(nx) + 0.05 * rng.normal(size=(nx, nx))).astype(
        np.float32)
    A2 = (0.2 * np.eye(nx) + 0.05 * rng.normal(size=(nx, nx))).astype(
        np.float32)
    B = (0.3 * rng.normal(size=(nx, nu))).astype(np.float32)
    return rng, A1, A2, B, N


def test_design_matrices_match_jax():
    """Condensed QP operators in float32 on both sides.  H, M1, M2 are
    short products (rtol 1e-5); the closed-form gain goes through a
    pinv of H'H: rtol 1e-3 of its scale."""
    rng, A1, A2, B, N = _controller()
    nx, nu = B.shape
    Q, P, R = 10.0 * np.eye(nx), 12.0 * np.eye(nx), np.eye(nu)
    ours = mpc.design_matrices(t32(A1), t32(A2), t32(B), N, t32(Q), t32(P),
                               t32(R))
    theirs = jmpc.design_matrices(*(jnp.asarray(a, jnp.float32) for a in
                                    (A1, A2, B)), N,
                                  *(jnp.asarray(a, jnp.float32)
                                    for a in (Q, P, R)))
    for name in ("M1", "M2", "B_conv", "Q_tilda", "R_tilda", "E", "H",
                 "M1B", "M2B"):
        np.testing.assert_allclose(npy(getattr(ours, name)),
                                   np.asarray(getattr(theirs, name)),
                                   rtol=1e-5, atol=1e-6, err_msg=name)
    cf = np.asarray(theirs.closed_form)
    np.testing.assert_allclose(npy(ours.closed_form), cf, rtol=0,
                               atol=1e-3 * np.abs(cf).max())
    x0 = rng.normal(size=(4, nx)).astype(np.float32)
    xp = rng.normal(size=(4, nx)).astype(np.float32)
    u1 = rng.normal(size=(4, nu)).astype(np.float32)
    u2 = rng.normal(size=(4, nu)).astype(np.float32)
    bref = mpc.b_ref(ours, t32(u1), t32(u2))
    r, c, xf = mpc.gradient_terms(ours, t32(x0), t32(xp), bref)
    jbref = jmpc.b_ref(theirs, jnp.asarray(u1), jnp.asarray(u2))
    jr, jc, jxf = jmpc.gradient_terms(theirs, jnp.asarray(x0),
                                      jnp.asarray(xp), jbref)
    for a, b in ((bref, jbref), (r, jr), (c, jc), (xf, jxf)):
        np.testing.assert_allclose(npy(a), np.asarray(b), rtol=1e-4,
                                   atol=1e-4)
    U = solvers.closed_form(ours, r)
    np.testing.assert_allclose(
        npy(mpc.cost(ours, U, r, c)),
        np.asarray(jmpc.cost(theirs, jnp.asarray(npy(U)), jr, jc)),
        rtol=1e-4)
    np.testing.assert_allclose(
        npy(mpc.predicted_states(ours, U, xf)),
        np.asarray(jmpc.predicted_states(theirs, jnp.asarray(npy(U)), jxf)),
        rtol=1e-4, atol=1e-4)


def _problems(A1, A2, B):
    kw = dict(q_weight=1.5e4, p_weight=1.5e4, r_weight=1.0, u_max=28.0,
              barrier_k=1e-2, du_max=0.2121)
    ours = solvers.make_fastmpc_problem(t32(A1), t32(A2), t32(B), **kw)
    theirs = jsolvers.make_fastmpc_problem(
        jnp.asarray(A1), jnp.asarray(A2), jnp.asarray(B), **kw)
    return ours, theirs


def test_fixed_newton_operator_matches_jax():
    """precompute_fixed_newton in float32 on both sides: the inverse of
    the Schur complement S (cond ~1e3 here) agrees to rtol 1e-3 of its
    scale; the port's float64 build of the same problem agrees too."""
    _, A1, A2, B, N = _controller(seed=1)
    ours, theirs = _problems(A1, A2, B)
    op = newton_kkt.precompute_fixed_newton(ours, N)
    jop = jnk.precompute_fixed_newton(theirs, N)
    want = np.asarray(jop.neg_s_inv)
    for got in (op, tree.cast(newton_kkt.precompute_fixed_newton(
            tree.cast(ours, torch.float64), N), torch.float32)):
        np.testing.assert_allclose(npy(got.neg_s_inv), want, rtol=0,
                                   atol=1e-3 * np.abs(want).max())
        np.testing.assert_allclose(npy(got.pu0), np.asarray(jop.pu0),
                                   rtol=1e-6)
        np.testing.assert_allclose(npy(got.px), np.asarray(jop.px),
                                   rtol=1e-6)


def test_solve_fixed_matches_jax_on_random_states():
    """Batched solve_fixed (with the 16-candidate line search) vs the JAX
    single-scenario solve under vmap, on random states of the loop's
    scale, same operators: U agrees to 1e-4 of max|U|."""
    rng, A1, A2, B, N = _controller(seed=2)
    ours, theirs = _problems(A1, A2, B)
    jop = jnk.precompute_fixed_newton(theirs, N)
    op = newton_kkt.FixedNewtonOperator(
        neg_s_inv=t32(jop.neg_s_inv), pu0=t32(jop.pu0), px=t32(jop.px))
    nx = B.shape[0]
    n = 16
    x0 = (rng.normal(size=(n, nx)) * 0.5).astype(np.float32)
    xp = (rng.normal(size=(n, nx)) * 0.5).astype(np.float32)
    w = (rng.normal(size=(n, N * nx)) * 0.1).astype(np.float32)
    st = newton_kkt.solve_fixed(ours, op, t32(x0), t32(xp), t32(w),
                                horizon=N)
    jst = jax.vmap(lambda a, b_, c_: jnk.solve_fixed(
        theirs, jop, a, b_, c_, horizon=N))(jnp.asarray(x0),
                                            jnp.asarray(xp), jnp.asarray(w))
    for name in ("U", "X", "nu"):
        want = np.asarray(getattr(jst, name))
        np.testing.assert_allclose(npy(getattr(st, name)), want, rtol=0,
                                   atol=1e-4 * np.abs(want).max(),
                                   err_msg=name)
    assert st.U.shape == (n, N, B.shape[1])


def test_line_search_picks_first_accepted_candidate():
    """A direction that leaves the box at t=1 must be cut back to the
    first candidate t=0.5^k that keeps every control strictly inside,
    as in the JAX line search."""
    rng, A1, A2, B, N = _controller(seed=3)
    ours, theirs = _problems(A1, A2, B)
    nx, nu = B.shape
    x0 = (rng.normal(size=(2, nx))).astype(np.float32)
    b = newton_kkt.equality_rhs(ours, t32(x0), t32(x0),
                                torch.zeros(2, N * nx), N)
    state = newton_kkt.init_state(ours, N)
    dU = torch.zeros(2, N, nu)
    dU[0, 0, 0] = 100.0        # t=1, 0.5 leave the +-28 box; t=0.25 fits
    dU[1, 0, 0] = 1.0
    direction = (dU, torch.zeros(2, N, nx), torch.zeros(2, N, nx))
    got = newton_kkt.line_search_step(ours, b, state, direction)
    jb = jnk.equality_rhs(theirs, jnp.asarray(x0[0]), jnp.asarray(x0[0]),
                          jnp.zeros(N * nx), N)
    jst = jnk.SolverState(jnp.zeros((N, nu)), jnp.zeros((N, nx)),
                          jnp.zeros((N, nx)))
    want = jnk.line_search_step(
        theirs, jb, jst, (jnp.asarray(npy(dU[0])), jnp.zeros((N, nx)),
                          jnp.zeros((N, nx))))
    np.testing.assert_allclose(npy(got.U[0]), np.asarray(want.U), rtol=1e-6)
    assert float(got.U[0, 0, 0]) < 28.0


@pytest.mark.parametrize("solver", ["barrier", "cvx"])
def test_unknown_solver_raises(solver):
    """A solver name outside the loop's switch raises ValueError before
    the loop runs, as the JAX switch does ("barrier", which the config
    comment once listed, included); every name of the switch passes."""
    with pytest.raises(ValueError, match="unknown solver"):
        closed_loop.check_solver(solver)
    with pytest.raises(ValueError, match="unknown solver"):
        closed_loop.simulate(None, None, reference_config(resolution=32),
                             None, 1, solver=solver)
    for name in closed_loop.SOLVERS:
        closed_loop.check_solver(name)
