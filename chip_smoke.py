"""Drive the PyTorch port's paths once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one printed line or more each; any failure raises and exits
non-zero (so does a machine without CUDA, or a directory without the
package):

1. device: the card's name and power limit (nvidia-smi), torch and CUDA.
2. build: compile kernels B1-B5 (csrc/psf_div3_sym.cu, psf_div.cu,
   psf_crop.cu, psf_div3_sym_thin.cu, transc_sincos.cu, transc_cos.cu)
   with nvcc for sm_90a, one nvcc each, all started together; print each
   build's seconds and ptxas registers, shared memory and spills.
3. kernel: each kernel against its plain PyTorch version on the card.
   B1-B4 at the shapes phase 4 times: R=128, B=4096 (the main path's; B3
   at N=12,288) and R=512, B=256, on speckled phases (std 0.4 rad) with
   the real defocus diversity; B2 also on a random 5-map stack, B3 on the
   total phases (rtol 2e-4; atol 1e-5 of the batch's PSF peak, because
   both sum R^2 unit-modulus field terms in float32 in different orders
   -- an error that scales with the peak amplitude).  B5a/B5b at (4096,
   4096) and at the ragged (1000, 1000), k = 8 and 32, on the JAX
   script's inputs (all 0.7) and on seeded U(-3, 3) (atol 1e-6: both
   chains contract, so rounding does not grow with k).
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
6. trace: one torch.profiler trace of a 25-step B1 run, right after the
   timed runs: device busy time, the idle share of the traced run, and
   the top device kernels and ops.
7. peaks: the device-peaks entry point (benchmarks/device_peaks.py), the
   path of B5a/B5b: every measured ceiling beside the card's name and
   power limit; each kernel must launch >= k1 + k2 times, and no rate may
   exceed 105% of its published peak.
8. roofline: rows of the roofline entry point (benchmarks/roofline.py)
   on the slice's build -- B1 at R=128 B=4096 and R=512 B=256, the step
   at R=128 B=4096 with 0 and 1 Gauss-Newton iterations, solve_fixed
   N=2 B=1024 -- each as a share of the published and of the measured
   peaks (none may exceed 105%); B1-B4 against the measured FP32
   ceiling.
9. one JSON line listing the kernels, then the last line
   {"ok": true, "device": {...}}.
"""

import concurrent.futures
import dataclasses
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch
from torch.autograd import DeviceType

from mpc_sensorlessao_tpu_torch.benchmarks import device_peaks
from mpc_sensorlessao_tpu_torch.benchmarks import kernel_variants, roofline
from mpc_sensorlessao_tpu_torch.models import closed_loop, estimator
from mpc_sensorlessao_tpu_torch.models import pipeline
from mpc_sensorlessao_tpu_torch.ops import cuda_build, dft, psf, psf_kernels
from mpc_sensorlessao_tpu_torch.ops import zernike
from mpc_sensorlessao_tpu_torch.parallel import montecarlo
from mpc_sensorlessao_tpu_torch.utils import profiling, tree

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
P = device_peaks
PEAKS_SRC = "benchmarks/device_peaks.py"
# (library, wrapper, plain version, kernel body it replaces) of the chain
# kernels, whose path is the device-peaks run
CHAINS = (
    ("transc_sincos", P.transc_sincos_chain, P.transc_sincos_chain_ref,
     f"{PEAKS_SRC}:152"),
    ("transc_cos", P.transc_cos_chain, P.transc_cos_chain_ref,
     f"{PEAKS_SRC}:195"),
)
CHAIN_SHAPES = ((4096, 4096), (1000, 1000))
CHAIN_ATOL = 1e-6
MAX_SHARE = 1.05
TRACE_DIR = Path(__file__).resolve().parent / "build" / "trace"
CROP_HALF = 15
DIVERSITY_AMP = 3.0
STEPS = 25
BATCH = 4096
# (R, B) of the kernel checks and timings: the main path's, and R=512
SHAPES = ((128, BATCH), (512, 256))
MIN_STREHL = 0.975
ROUTE_STREHL_TOL = 0.002


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def reset_launches() -> None:
    for _, wrapper, *_ in KERNELS + CHAINS:
        wrapper.launches = 0


def device_phase() -> str:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this needs an NVIDIA GPU")
    card = profiling.card()
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

    names = [k[0] for k in KERNELS + CHAINS]
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
    rng = np.random.default_rng(2)
    for shape in CHAIN_SHAPES:
        inputs = (("0.7", torch.full(shape, 0.7, device=dev)),
                  ("U(-3,3)", torch.as_tensor(rng.uniform(
                      -3, 3, size=shape).astype(np.float32), device=dev)))
        for lib, wrapper, plain, _ in CHAINS:
            for label, x in inputs:
                for k in (P.K1, P.K2):
                    got = wrapper(x, k)
                    torch.cuda.synchronize()
                    err = float((got - plain(x, k)).abs().max())
                    print(f"kernel {lib} vs plain, {shape} {label} k={k}: "
                          f"max_abs_err {err:.3e}; tolerance atol "
                          f"{CHAIN_ATOL:g}")
                    if not err <= CHAIN_ATOL:
                        fail(f"{lib} disagrees with its plain version at "
                             f"{shape}, {label}, k={k}")
                    max_err[lib] = max(max_err.get(lib, 0.0), err)
    return max_err


def bound(variant: str, R: int, B: int, f32_flops: float | None = None):
    """(bound ms, "operations" or "bytes") of one call of a variant of
    the A/B at (R, B): the larger of its FLOPs
    (``roofline.measure_work``) over the published FP32 peak -- or over
    ``f32_flops``, a measured ceiling -- and its bytes over the published
    HBM rate."""
    work = roofline.measure_work(variant, R, roofline.CROP, B)
    peak = profiling.DEVICE_PEAKS[profiling.device_kind()]
    t_ops = work["flops"] / (f32_flops or peak["fp32_flops"])
    t_bytes = work["bytes_accessed"] / peak["hbm_bytes_per_s"]
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


def peaks_phase(card: str) -> tuple[dict, dict, dict]:
    """The device-peaks entry point, the path of B5a/B5b.  Returns its
    report, the chain kernels' launches in it, and their entries of the
    kernels line (ms, plain_ms, library_ms, bound_ms, bound_by)."""
    reset_launches()
    report = device_peaks.run()
    launches = {lib: wrapper.launches for lib, wrapper, *_ in CHAINS}
    for lib, n in launches.items():
        if n < P.K1 + P.K2:
            fail(f"the device-peaks run launched {lib} {n} times, fewer "
                 f"than k1 + k2 = {P.K1 + P.K2}")
    published = profiling.DEVICE_PEAKS[profiling.device_kind()]
    peaks = report["peaks"]
    for key, pub, unit in (("f32_flops", "fp32_flops", "TFLOP/s"),
                           ("tf32_flops", "tf32_flops", "TFLOP/s"),
                           ("bf16_flops", "bf16_flops", "TFLOP/s"),
                           ("hbm_bytes_per_s", "hbm_bytes_per_s", "TB/s")):
        share = peaks[key] / published[pub]
        print(f"peaks: {key} {peaks[key] / 1e12:.3f} {unit} measured, "
              f"{100 * share:.1f}% of the published {published[pub] / 1e12:g}"
              f" [{card}]")
        if share > MAX_SHARE:
            fail(f"measured {key} is {100 * share:.1f}% of its published "
                 "peak")
    for key in ("transc_cos", "transc_exp", "transc_cos_kernel",
                "transc_sincos_kernel"):
        e = report[key]
        print(f"peaks: {key} {e['gtransc_per_s']:.2f} G transcendentals/s "
              f"(slope of t_k{e['k1']} {e['t_k1_ms']:.4f} ms, t_k{e['k2']} "
              f"{e['t_k2_ms']:.4f} ms over {e['elements']} elements) "
              f"[{card}]")
    print(f"peaks: transc_per_s {peaks['transc_per_s'] / 1e9:.2f} G/s (best),"
          f" transc_torch_per_s {peaks['transc_torch_per_s'] / 1e9:.2f} G/s "
          f"[{card}]")
    # one call at the peaks run's shape and depth k2, beside the plain
    # version and the torch chain of k2 torch.cos (no single PyTorch call
    # computes k links; for B5b the chain is its plain version)
    x = torch.full(P.KERNEL_SHAPE, 0.7, device="cuda")
    library_ms = profiling.cuda_time_ms(
        lambda: P.transc_cos_chain_ref(x, P.K2), 3)
    line = {}
    for lib, _, plain, _ in CHAINS:
        ms = report[lib + "_kernel"]["t_k2_ms"]
        plain_ms = (library_ms if lib == "transc_cos" else
                    profiling.cuda_time_ms(lambda: plain(x, P.K2), 3))
        b = P.chain_bound(lib, P.KERNEL_SHAPE, P.K2)
        print(f"chain {lib} {P.KERNEL_SHAPE} k={P.K2}: kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms, torch cos chain {library_ms:.4f} "
              f"ms; per element and link {b['fp32']:g} FP32 / "
              f"{b['issued']:g} issued SASS instructions (recorded); bound "
              f"{b['bound_ms']:.4f} ms ({b['bound_by']}; FP32 "
              f"{b['ops_ms']:.4f} ms at {b['sms']} SMs x 128 lanes x "
              f"{b['max_sm_clock_hz'] / 1e6:g} MHz, bytes "
              f"{b['bytes_ms']:.4f} ms, issue {b['issue_ms']:.4f} ms), "
              f"{100 * b['bound_ms'] / ms:.1f}% of bound [{card}]")
        line[lib] = {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                     "bound_ms": b["bound_ms"], "bound_by": b["bound_by"]}
    return report, launches, line


def slice_cfg():
    cfg = roofline.bench_cfg(128)
    return cfg.replace(estimator=dataclasses.replace(cfg.estimator,
                                                     gauss_newton_iters=0))


def on_route(loop, route: str):
    return dataclasses.replace(loop, est=estimator.with_route(loop.est,
                                                              route))


def slice_phase(system, cfg, dev, card: str) -> tuple[dict, dict]:
    """Launches of each route's kernel in its 25-step loop, and each
    route's best run seconds."""
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
    return launches, {route: min(ts) for route, ts in times.items()}


def roofline_phase(system, cfg, peaks: dict, times: dict, card: str):
    """Roofline rows on the slice's build, against the published and the
    measured peaks; B1-B4 against the measured FP32 ceiling."""
    rows = [roofline.measure_row(R, B, peaks) for R, B in SHAPES]
    rows += [roofline.step_row(system, cfg, BATCH, gn, peaks)
             for gn in (0, 1)]
    rows.append(roofline.solve_row(system, peaks=peaks))
    for r in rows:
        print(f"roofline {r['label']}: {r['wall_us_per_iter']:.2f} us per "
              f"iteration; {r['achieved_tflops']:.3f} TFLOP/s = "
              f"{r['pct_published_fp32']:.2f}% of published FP32, "
              f"{r['pct_measured_fp32']:.2f}% of measured; "
              f"{r['achieved_gbps']:.1f} GB/s = {r['pct_published_hbm']:.2f}% "
              f"of published HBM, {r['pct_measured_hbm']:.2f}% of measured; "
              f"{r['achieved_gtransc_per_s']:.2f} G transcendentals/s = "
              f"{r['pct_measured_transc']:.2f}% of measured; bound "
              f"{r['bound']} [{card}]")
        for key in ("pct_published_fp32", "pct_published_hbm",
                    "pct_measured_fp32", "pct_measured_hbm",
                    "pct_measured_transc"):
            if r[key] > 100 * MAX_SHARE:
                fail(f"roofline {r['label']}: {key} = {r[key]:.1f}%")
    for v, (k_ms, _) in times.items():
        pub_ms, _ = bound(v, 128, BATCH)
        meas_ms, _ = bound(v, 128, BATCH, f32_flops=peaks["f32_flops"])
        print(f"variant {v} R=128 B={BATCH}: {k_ms:.4f} ms; "
              f"{100 * pub_ms / k_ms:.1f}% of the published-FP32 bound "
              f"{pub_ms:.4f} ms, {100 * meas_ms / k_ms:.1f}% of the "
              f"measured-FP32 bound {meas_ms:.4f} ms [{card}]")
        if meas_ms / k_ms > MAX_SHARE:
            fail(f"variant {v} beats the measured FP32 ceiling by more "
                 "than 5%")


def trace_phase(system, cfg, untraced_s: float, card: str) -> None:
    """One torch.profiler trace of the 25-step B1 run: device busy time
    against the traced run's own wall time (and, beside it, against the
    untraced run timed just before), and the top kernels and ops by
    device time."""
    scen = montecarlo.make_scenarios(cfg, torch.Generator().manual_seed(1),
                                     BATCH, device="cuda")
    with profiling.trace(str(TRACE_DIR)) as prof:
        t0 = time.perf_counter()
        montecarlo.run_batch(system.loop, system.layers, cfg, scen, STEPS,
                             shared_window="verified")
        torch.cuda.synchronize()
        traced_s = time.perf_counter() - t0
    avg = prof.key_averages()
    kernels = sorted((e for e in avg if e.device_type == DeviceType.CUDA),
                     key=lambda e: -e.self_device_time_total)
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    if busy_ms == 0:
        print("trace: key_averages() shows no device time; the CUDA-event "
              "and host-clock times above stand")
        return
    print(f"trace: {STEPS}-step B1 run, B={BATCH}: device busy {busy_ms:.3f}"
          f" ms in {traced_s * 1e3:.2f} ms traced, so the device is idle "
          f"{100 * (1 - busy_ms / (traced_s * 1e3)):.1f}% of the traced "
          f"run ({100 * (1 - busy_ms / (untraced_s * 1e3)):.1f}% of the "
          f"best untraced run just before, {untraced_s * 1e3:.2f} ms); "
          f"{len(kernels)} kernel names [{card}]")
    for e in kernels[:10]:
        ms = e.self_device_time_total / 1e3
        name = e.key.replace("void ", "").replace("at::native::", "")
        print(f"trace kernel: {ms:.3f} ms ({100 * ms / busy_ms:.1f}%), "
              f"{e.count} calls: {name[:120]}")
    ops = sorted((e for e in avg if e.device_type == DeviceType.CPU
                  and e.self_device_time_total > 0),
                 key=lambda e: -e.self_device_time_total)
    for e in ops[:10]:
        ms = e.self_device_time_total / 1e3
        print(f"trace op: {ms:.3f} ms ({100 * ms / busy_ms:.1f}%), "
              f"{e.count} calls: {e.key}")


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
    cfg = slice_cfg()
    t0 = time.time()
    system = pipeline.build(cfg, dev)
    torch.cuda.synchronize()
    print(f"slice: pipeline.build at R={cfg.resolution} in "
          f"{time.time() - t0:.2f} s")
    loop_launches, run_s = slice_phase(system, cfg, dev, card)
    trace_phase(system, cfg, run_s["sym3"], card)
    report, chain_launches, chain_line = peaks_phase(card)
    roofline_phase(system, cfg, report["peaks"], times, card)
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
    for lib, _, _, replaces in CHAINS:
        kernels.append({
            "name": lib, "route": "cuda", "source": f"{CSRC}/{lib}.cu",
            "replaces": replaces, "launches": chain_launches[lib],
            "max_abs_err": max_err[lib], **chain_line[lib]})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
