"""Drive the PyTorch port's paths once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one printed line or more each; any failure raises and exits
non-zero (so does a machine without CUDA, or a directory without the
package):

1. device: the card's name and power limit (nvidia-smi), torch and CUDA.
2. build: compile kernels B1-B4 (csrc/psf_div3_sym.cu, psf_div.cu,
   psf_crop.cu, psf_div3_sym_thin.cu) with nvcc for sm_90a, one nvcc
   each, all started together; print each build's seconds and ptxas
   registers, shared memory and spills.
3. kernel: each kernel against its plain PyTorch version on the card at
   the shapes phase 4 times: R=128, B=4096 (the main path's; B3 at
   N=12,288) and R=512, B=256, on speckled phases (std 0.4 rad) with the
   real defocus diversity; B2 also on a random 5-map stack, B3 on the
   total phases (rtol 2e-4; atol 1e-5 of the batch's PSF peak, because
   both sum R^2 unit-modulus field terms in float32 in different orders
   -- an error that scales with the peak amplitude).
4. variants: the kernel A/B entry point (benchmarks/kernel_variants.py)
   at R=128, B=4096 -- the main path's shapes, B3 at N=12,288 -- and at
   R=512, B=256, in turns kernels, plain versions, kernels.  Its first
   run is the path that launches B4: every kernel must launch there.
5. slice: reference_config(resolution=128) cut as bench.py cuts it
   (n_train=300, n_valid=50, 25 steps, gauss_newton_iters=0): build on
   the card, 4096 shared-window scenarios, run_batch for 25 steps,
   measuring through each route of the estimator's switch -- B1 (the
   build's default), B2 (div_sym3 off), B3 (no diversity cos/sin maps).
   Each run must launch its kernel >= 25 times, give finite outputs and
   a settled exact Strehl >= 0.975, within 0.002 of the B1 run's; then
   the best of 3 timed runs.  The same loop at B=4 with injected noise
   on the card and on the CPU (plain versions) must agree (residual RMS
   rtol 0.01, u atol 0.02 max|u|, as tests/test_golden_trajectory.py).
6. one JSON line listing the kernels, then the last line
   {"ok": true, "device": {...}}.
"""

import concurrent.futures
import dataclasses
import json
import sys
import time

import numpy as np
import torch

from mpc_sensorlessao_tpu_torch import reference_config
from mpc_sensorlessao_tpu_torch.benchmarks import kernel_variants
from mpc_sensorlessao_tpu_torch.models import closed_loop, estimator
from mpc_sensorlessao_tpu_torch.models import pipeline
from mpc_sensorlessao_tpu_torch.ops import cuda_build, dft, psf, psf_kernels
from mpc_sensorlessao_tpu_torch.ops import zernike
from mpc_sensorlessao_tpu_torch.parallel import montecarlo
from mpc_sensorlessao_tpu_torch.utils import tree

PALLAS = "mpc_sensorlessao_tpu/ops/pallas_kernels.py"
CSRC = "mpc_sensorlessao_tpu_torch/csrc"
K = psf_kernels
# (library, wrapper, plain version, kernel body it replaces, variant of
# the A/B entry point, loop route)
KERNELS = (
    ("psf_div3_sym", K.psf_crop_diversity_sym3,
     K.psf_crop_diversity_sym3_ref, f"{PALLAS}:115", "sym3", "sym3"),
    ("psf_div", K.psf_crop_diversity, K.psf_crop_diversity_ref,
     f"{PALLAS}:65", "general", "general"),
    ("psf_crop", K.psf_crop_intensity, K.psf_crop_intensity_ref,
     f"{PALLAS}:26", "unfused", "unfused"),
    ("psf_div3_sym_thin", K.psf_crop_diversity_sym3_thin,
     K.psf_crop_diversity_sym3_thin_ref, f"{PALLAS}:178", "sym3_thin",
     None),
)
CROP_HALF = 15
DIVERSITY_AMP = 3.0
STEPS = 25
BATCH = 4096
# (R, B) of the kernel checks and timings: the main path's, and R=512
SHAPES = ((128, BATCH), (512, 256))
MIN_STREHL = 0.975
ROUTE_STREHL_TOL = 0.002
# H100 SXM data sheet at 700 W: FP32 outside the tensor cores, HBM3
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def reset_launches() -> None:
    for _, wrapper, *_ in KERNELS:
        wrapper.launches = 0


def device_phase() -> str:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this needs an NVIDIA GPU")
    card = kernel_variants.card()
    print(card)
    print(f"device: {torch.cuda.get_device_name(0)}; torch "
          f"{torch.__version__}; CUDA {torch.version.cuda}; "
          f"python {sys.version.split()[0]}")
    return card


def build_phase() -> None:
    def build(name):
        t0 = time.time()
        path, log = cuda_build.build(name, ptxas_info=True)
        return path, log, time.time() - t0

    names = [k[0] for k in KERNELS]
    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        results = list(pool.map(build, names))
    for name, (path, log, secs) in zip(names, results):
        print(f"build: {name}.cu -> {path.name} in {secs:.2f} s"
              + ("" if log else " (cached)"))
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"  ptxas: {line.strip()}")


def b1_args(R: int, B: int, dev):
    """Seeded speckled phases (std 0.4 rad per pixel) with the real
    defocus diversity, pupil, crop and PSF scale of the estimator."""
    rng = np.random.default_rng(0)
    phase = torch.as_tensor(
        (rng.normal(size=(B, R, R)) * 0.4).astype(np.float32), device=dev)
    z4 = zernike.make_basis(6, R, device=dev).stack[4]
    scale = float((6.5e-6 * 512.0 / R) ** 4 * 1e12)
    return (phase, psf.pupil_mask(R, device=dev),
            torch.cos(DIVERSITY_AMP * z4), torch.sin(DIVERSITY_AMP * z4),
            dft.centered_partial_dft(R, CROP_HALF, device=dev), scale)


def kernel_cases(R: int, B: int, dev):
    """(label, library, arguments) of every kernel check at (R, B)."""
    phase, pupil, cos_a, sin_a, op, scale = b1_args(R, B, dev)
    z4 = zernike.make_basis(6, R, device=dev).stack[4]
    triple = torch.stack([-DIVERSITY_AMP * z4, 0.0 * z4,
                          DIVERSITY_AMP * z4])
    rng = np.random.default_rng(1)
    five = torch.as_tensor(
        (rng.normal(size=(5, R, R)) * 0.8).astype(np.float32), device=dev)
    total = (phase[:, None] + triple).reshape(-1, R, R)
    return (
        ("B1", "psf_div3_sym", (phase, pupil, cos_a, sin_a, op, scale)),
        ("B2 (3 maps)", "psf_div",
         (phase, pupil, torch.cos(triple), torch.sin(triple), op, scale)),
        ("B2 (5 random maps)", "psf_div",
         (phase, pupil, torch.cos(five), torch.sin(five), op, scale)),
        ("B3 (total phases)", "psf_crop", (total, pupil, op, scale)),
        ("B4", "psf_div3_sym_thin", (phase, pupil, cos_a, sin_a, op, scale)),
    )


def kernel_phase(dev) -> dict:
    """Max abs error of each kernel against its plain version."""
    funcs = {k[0]: (k[1], k[2]) for k in KERNELS}
    max_err = {k[0]: 0.0 for k in KERNELS}
    for R, B in SHAPES:
        for label, lib, args in kernel_cases(R, B, dev):
            wrapper, plain = funcs[lib]
            got = wrapper(*args)
            torch.cuda.synchronize()
            want = plain(*args)
            if got.shape != want.shape or not torch.isfinite(got).all():
                fail(f"{label} output at R={R} B={B}: shape "
                     f"{tuple(got.shape)}, or not finite")
            err = (got - want).abs()
            peak = float(want.abs().max())
            atol = 1e-5 * peak
            rel = float((err / want.abs().clamp_min(atol)).max())
            print(f"kernel {label} vs plain, R={R} B={B}: max_abs_err "
                  f"{float(err.max()):.3e} (peak {peak:.4g}), max rel err "
                  f"{rel:.3e}; tolerance rtol 2e-4, atol {atol:.3e}")
            if not bool((err <= 2e-4 * want.abs() + atol).all()):
                fail(f"{label} disagrees with its plain version at R={R} "
                     f"B={B}")
            max_err[lib] = max(max_err[lib], float(err.max()))
    return max_err


def bound(variant: str, R: int, B: int, w: int = 2 * CROP_HALF + 1):
    """(bound ms, "operations" or "bytes") of one call of a variant of
    the A/B at (R, B): the larger of its FP32 FMAs over the FP32 peak and
    the bytes it must move over the HBM rate.  Every variant forms 3 B
    fields and takes each through A F A^T: 4 w R^2 + 4 w^2 R FMAs (the
    field's sincosf and products, O(R^2), are left out).  Bytes: each
    input read once -- the phases (B3: the 3 B total phases), the
    pupil, the diversity maps (B1, B4: cos/sin of a Z4; B2: cos/sin of
    the 3 maps) and the complex operator -- and the (3 B, w, w) output
    written once."""
    fields = 3 * B
    flops = 2 * 4 * fields * (w * R * R + w * w * R)
    maps = {"sym3": 2, "sym3_thin": 2, "general": 6, "unfused": 0}[variant]
    phases = fields if variant == "unfused" else B
    floats = (phases + 1 + maps) * R * R + 2 * w * R + fields * w * w
    t_ops, t_bytes = flops / PEAK_FP32, 4 * floats / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def variants_phase(card: str) -> tuple[dict, dict]:
    """The A/B entry point in turns kernels, plain, kernels; returns the
    main shape's times per variant and the launches of its first run."""
    times = {}
    for R, B in SHAPES:
        reset_launches()
        k1 = kernel_variants.run(R, B)
        if (R, B) == (128, BATCH):
            launches = {k[0]: k[1].launches for k in KERNELS}
        plain = kernel_variants.run(R, B, plain=True, reps=5)
        k2 = kernel_variants.run(R, B)
        for run_ in (k1, plain, k2):
            print("variants: " + json.dumps(run_))
        for v in kernel_variants.VARIANTS:
            k_ms, p_ms = min(k1[v + "_ms"], k2[v + "_ms"]), plain[v + "_ms"]
            b_ms, b_by = bound(v, R, B)
            print(f"variant {v} R={R} B={B}: kernel {k1[v + '_ms']:.4f} / "
                  f"{k2[v + '_ms']:.4f} ms, plain {p_ms:.4f} ms per call, "
                  f"bound {b_ms:.4f} ms ({b_by}), {100 * b_ms / k_ms:.1f}% "
                  f"of bound [{card}]")
            if (R, B) == (128, BATCH):
                times[v] = (k_ms, p_ms)
    for lib, n in launches.items():
        if n < 1:
            fail(f"the kernel A/B launched {lib} {n} times")
    return times, launches


def slice_cfg():
    cfg = reference_config(resolution=128)
    return cfg.replace(
        sim=dataclasses.replace(cfg.sim, n_train=300, n_valid=50,
                                n_test=STEPS),
        estimator=dataclasses.replace(cfg.estimator, gauss_newton_iters=0))


def on_route(loop, route: str):
    return dataclasses.replace(loop, est=estimator.with_route(loop.est,
                                                              route))


def slice_phase(dev, card: str) -> dict:
    """Launches of each route's kernel in its 25-step loop."""
    cfg = slice_cfg()
    t0 = time.time()
    system = pipeline.build(cfg, dev)
    torch.cuda.synchronize()
    print(f"slice: pipeline.build at R={cfg.resolution} in "
          f"{time.time() - t0:.2f} s")
    scen = montecarlo.make_scenarios(cfg, torch.Generator().manual_seed(1),
                                     BATCH, device=dev)
    montecarlo.assert_shared_window(scen)
    routes = [(lib, wrapper, route)
              for lib, wrapper, *_, route in KERNELS if route]

    def run(route):
        out = montecarlo.run_batch(on_route(system.loop, route),
                                   system.layers, cfg, scen, STEPS,
                                   shared_window="verified")
        torch.cuda.synchronize()
        return out

    launches = {}
    strehl_b1 = None
    for lib, wrapper, route in routes:
        reset_launches()
        out = run(route)
        launches[lib] = wrapper.launches
        if launches[lib] < STEPS:
            fail(f"the {route} loop launched {lib} {launches[lib]} times "
                 f"in {STEPS} steps")
        nu = system.loop.influence.shape[1]
        if out.u.shape != (BATCH, STEPS, nu):
            fail(f"{route}: u has shape {tuple(out.u.shape)}")
        for name, field in zip(out._fields, out):
            if not bool(torch.isfinite(field).all()):
                fail(f"{route}: non-finite {name}")
        settle = STEPS // 2
        strehl = float(out.strehl_exact[:, settle:].mean())
        marechal = float(out.strehl[:, settle:].mean())
        rms = float(out.rms_res[:, settle:].mean())
        if strehl < MIN_STREHL:
            fail(f"{route}: settled exact Strehl {strehl:.5f} < "
                 f"{MIN_STREHL}")
        if strehl_b1 is None:
            strehl_b1 = strehl
        elif abs(strehl - strehl_b1) > ROUTE_STREHL_TOL:
            fail(f"{route}: settled exact Strehl {strehl:.5f} is not within "
                 f"{ROUTE_STREHL_TOL} of the B1 loop's {strehl_b1:.5f}")
        print(f"slice ({route}, {lib}): R={cfg.resolution} B={BATCH} "
              f"steps={STEPS}: {lib} launches {launches[lib]}; settled "
              f"exact Strehl {strehl:.5f}, Marechal {marechal:.5f}, "
              f"residual RMS {rms:.5f} rad")
        reference_phase(on_route(system.loop, route), system.layers, cfg,
                        dev, route)
    # run times, the routes in turns: B1 B2 B3 B3 B2 B1 B1 B2 B3
    times = {route: [] for _, _, route in routes}
    for _, _, route in routes + routes[::-1] + routes:
        t0 = time.perf_counter()
        run(route)
        times[route].append(time.perf_counter() - t0)
    for route, ts in times.items():
        print(f"slice ({route}) run: {min(ts):.4f} s (best of {ts}), "
              f"{BATCH * STEPS / min(ts):.1f} solves/s [{card}]")
    return launches


def reference_phase(loop, layers, cfg, dev, route: str) -> None:
    """The loop at B=4 on the card (kernel) and on the CPU (plain
    version), same operators and injected noise."""
    B = 4
    rng = np.random.default_rng(5)
    noise = torch.as_tensor(
        (float(loop.est.noise_std) * rng.standard_normal(
            (B, STEPS, loop.est.n_pixels))).astype(np.float32))
    mag = torch.linspace(1.0, 1.8, B)
    kw = dict(n_steps=STEPS, start_step=cfg.sim.n_train + cfg.sim.n_valid,
              mag=mag)
    gpu = closed_loop.simulate(loop, layers, cfg, None,
                               noise_seq=noise.to(dev), **kw)
    cpu = closed_loop.simulate(tree.cast(loop, device="cpu"),
                               tree.cast(layers, device="cpu"), cfg,
                               None, noise_seq=noise, **kw)
    u_ref, rms_ref = cpu.u.numpy(), cpu.rms_res.numpy()
    u, rms = gpu.u.cpu().numpy(), gpu.rms_res.cpu().numpy()
    u_err = float(np.abs(u - u_ref).max() / np.abs(u_ref).max())
    rms_err = float(np.max(np.abs(rms - rms_ref) / rms_ref))
    print(f"reference ({route}): B={B} loop on the card vs on the CPU: u "
          f"max err {u_err:.3e} of max|u| (tolerance 0.02), residual RMS "
          f"max rel err {rms_err:.3e} (tolerance 0.01)")
    if not np.allclose(rms, rms_ref, rtol=0.01, atol=5e-3) or u_err > 0.02:
        fail(f"{route}: the loop on the card disagrees with the CPU loop")


def main() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = device_phase()
    dev = torch.device("cuda:0")
    build_phase()
    max_err = kernel_phase(dev)
    times, variant_launches = variants_phase(card)
    loop_launches = slice_phase(dev, card)
    kernels = []
    for lib, _, _, replaces, variant, route in KERNELS:
        ms, plain_ms = times[variant]
        bound_ms, bound_by = bound(variant, 128, BATCH)
        kernels.append({
            "name": lib, "route": "cuda", "source": f"{CSRC}/{lib}.cu",
            "replaces": replaces,
            "launches": (loop_launches[lib] if route
                         else variant_launches[lib]),
            "max_abs_err": max_err[lib], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
