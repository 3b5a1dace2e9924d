"""Drive the PyTorch port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one printed line or more each; any failure raises and exits
non-zero (so does a machine without CUDA, or a directory without the
package):

1. device: the card's name and power limit (nvidia-smi), torch and CUDA.
2. build: compile kernel B1 (csrc/psf_div3_sym.cu) with nvcc for sm_90a.
3. kernel: B1 against its plain PyTorch version on the card at R=128,
   B=64 and R=512, B=8 (rtol 2e-4; atol 1e-5 of the batch's PSF peak,
   because both sum R^2 unit-modulus field terms in float32 in different
   orders -- an error that scales with the peak amplitude, measured at
   ~7e-7 of the peak for the plain version against float64), then the
   kernel's and the plain version's times at R=128, B=4096 (the main
   path) and R=512, B=256, with CUDA events.
4. slice: reference_config(resolution=128) cut as bench.py cuts it
   (n_train=300, n_valid=50, 25 steps, gauss_newton_iters=0): build on
   the card, 4096 shared-window scenarios, run_batch for 25 steps.  The
   B1 launch count of that run must be >= 25, every output finite, and
   the settled exact Strehl >= 0.975; then the best of 3 timed runs.
   The same loop at B=4 with injected noise on the card and on the CPU
   (plain version) must agree (residual RMS rtol 0.01, u atol
   0.02 max|u|, as tests/test_golden_trajectory.py).
5. one JSON line per kernel, then the last line
   {"ok": true, "device": {...}}.
"""

import dataclasses
import json
import subprocess
import sys
import time

import numpy as np
import torch

from mpc_sensorlessao_tpu_torch import reference_config
from mpc_sensorlessao_tpu_torch.models import closed_loop, pipeline
from mpc_sensorlessao_tpu_torch.ops import cuda_build, dft, psf, psf_kernels
from mpc_sensorlessao_tpu_torch.ops import zernike
from mpc_sensorlessao_tpu_torch.parallel import montecarlo
from mpc_sensorlessao_tpu_torch.utils import tree

KERNEL_SOURCE = "mpc_sensorlessao_tpu_torch/csrc/psf_div3_sym.cu"
KERNEL_REPLACES = "mpc_sensorlessao_tpu/ops/pallas_kernels.py:115"
CROP_HALF = 15
DIVERSITY_AMP = 3.0
STEPS = 25
BATCH = 4096
MIN_STREHL = 0.975


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def device_phase() -> str:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this needs an NVIDIA GPU")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card)
    print(f"device: {torch.cuda.get_device_name(0)}; torch "
          f"{torch.__version__}; CUDA {torch.version.cuda}; "
          f"python {sys.version.split()[0]}")
    return card


def build_phase() -> None:
    t0 = time.time()
    path, log = cuda_build.build("psf_div3_sym", ptxas_info=True)
    print(f"build: {path.name} in {time.time() - t0:.2f} s"
          + ("" if log else " (cached)"))
    for line in log.splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            print(f"  ptxas: {line.strip()}")


def b1_args(R: int, B: int, dev, seed: int = 0):
    """Seeded speckled phases (std 0.4 rad per pixel) with the real
    defocus diversity, pupil, crop and PSF scale of the estimator."""
    rng = np.random.default_rng(seed)
    phase = torch.as_tensor(
        (rng.normal(size=(B, R, R)) * 0.4).astype(np.float32), device=dev)
    z4 = zernike.make_basis(6, R, device=dev).stack[4]
    scale = float((6.5e-6 * 512.0 / R) ** 4 * 1e12)
    return (phase, psf.pupil_mask(R, device=dev),
            torch.cos(DIVERSITY_AMP * z4), torch.sin(DIVERSITY_AMP * z4),
            dft.centered_partial_dft(R, CROP_HALF, device=dev), scale)


def time_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def kernel_phase(dev, card: str) -> dict:
    max_err = 0.0
    for R, B in ((128, 64), (512, 8)):
        args = b1_args(R, B, dev)
        got = psf_kernels.psf_crop_diversity_sym3(*args)
        torch.cuda.synchronize()
        want = psf_kernels.psf_crop_diversity_sym3_ref(*args)
        if got.shape != want.shape or not torch.isfinite(got).all():
            fail(f"B1 output at R={R} B={B}: shape {tuple(got.shape)}, "
                 "or not finite")
        err = (got - want).abs()
        peak = float(want.abs().max())
        atol = 1e-5 * peak
        rel = float((err / want.abs().clamp_min(atol)).max())
        print(f"kernel B1 vs plain, R={R} B={B}: max_abs_err "
              f"{float(err.max()):.3e} (peak {peak:.4g}), max rel err "
              f"{rel:.3e}; tolerance rtol 2e-4, atol {atol:.3e}")
        if not bool((err <= 2e-4 * want.abs() + atol).all()):
            fail(f"B1 disagrees with its plain version at R={R} B={B}")
        max_err = max(max_err, float(err.max()))
    times = {}
    for R, B in ((128, BATCH), (512, 256)):
        args = b1_args(R, B, dev, seed=1)
        k_ms = time_ms(lambda: psf_kernels.psf_crop_diversity_sym3(*args), 20)
        p_ms = time_ms(lambda: psf_kernels.psf_crop_diversity_sym3_ref(*args),
                       5)
        k2_ms = time_ms(lambda: psf_kernels.psf_crop_diversity_sym3(*args),
                        20)
        times[(R, B)] = (min(k_ms, k2_ms), p_ms)
        print(f"kernel B1 time, R={R} B={B}: kernel {k_ms:.4f} / "
              f"{k2_ms:.4f} ms, plain {p_ms:.4f} ms per call [{card}]")
    k_ms, p_ms = times[(128, BATCH)]
    return {"max_abs_err": max_err, "ms": k_ms, "plain_ms": p_ms}


def slice_cfg():
    cfg = reference_config(resolution=128)
    return cfg.replace(
        sim=dataclasses.replace(cfg.sim, n_train=300, n_valid=50,
                                n_test=STEPS),
        estimator=dataclasses.replace(cfg.estimator, gauss_newton_iters=0))


def slice_phase(dev, card: str) -> int:
    cfg = slice_cfg()
    t0 = time.time()
    system = pipeline.build(cfg, dev)
    torch.cuda.synchronize()
    build_s = time.time() - t0
    scen = montecarlo.make_scenarios(cfg, torch.Generator().manual_seed(1),
                                     BATCH, device=dev)
    montecarlo.assert_shared_window(scen)

    def run():
        out = montecarlo.run_batch(system.loop, system.layers, cfg, scen,
                                   STEPS, shared_window="verified")
        torch.cuda.synchronize()
        return out

    psf_kernels.psf_crop_diversity_sym3.launches = 0
    out = run()
    launches = psf_kernels.psf_crop_diversity_sym3.launches
    if launches < STEPS:
        fail(f"the main path launched B1 {launches} times in {STEPS} steps")
    nu = system.loop.influence.shape[1]
    if out.u.shape != (BATCH, STEPS, nu):
        fail(f"u has shape {tuple(out.u.shape)}")
    for name, field in zip(out._fields, out):
        if not bool(torch.isfinite(field).all()):
            fail(f"non-finite {name}")
    settle = STEPS // 2
    strehl = float(out.strehl_exact[:, settle:].mean())
    marechal = float(out.strehl[:, settle:].mean())
    rms = float(out.rms_res[:, settle:].mean())
    if strehl < MIN_STREHL:
        fail(f"settled exact Strehl {strehl:.4f} < {MIN_STREHL}")
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        run()
        times.append(time.perf_counter() - t0)
    best = min(times)
    print(f"slice: R=128 B={BATCH} steps={STEPS}: build {build_s:.2f} s, "
          f"run {best:.4f} s (best of {times}), "
          f"{BATCH * STEPS / best:.1f} solves/s, B1 launches {launches}; "
          f"settled exact Strehl {strehl:.5f}, Marechal {marechal:.5f}, "
          f"residual RMS {rms:.5f} rad [{card}]")
    reference_phase(system, cfg, dev)
    return launches


def reference_phase(system, cfg, dev) -> None:
    """The loop at B=4 on the card (kernel) and on the CPU (plain
    version), same operators and injected noise."""
    B = 4
    rng = np.random.default_rng(5)
    noise = torch.as_tensor(
        (float(system.est.noise_std) * rng.standard_normal(
            (B, STEPS, system.est.n_pixels))).astype(np.float32))
    mag = torch.linspace(1.0, 1.8, B)
    kw = dict(n_steps=STEPS, start_step=cfg.sim.n_train + cfg.sim.n_valid,
              mag=mag)
    gpu = closed_loop.simulate(system.loop, system.layers, cfg, None,
                               noise_seq=noise.to(dev), **kw)
    cpu = closed_loop.simulate(tree.cast(system.loop, device="cpu"),
                               tree.cast(system.layers, device="cpu"), cfg,
                               None, noise_seq=noise, **kw)
    u_ref, rms_ref = cpu.u.numpy(), cpu.rms_res.numpy()
    u, rms = gpu.u.cpu().numpy(), gpu.rms_res.cpu().numpy()
    u_err = float(np.abs(u - u_ref).max() / np.abs(u_ref).max())
    rms_err = float(np.max(np.abs(rms - rms_ref) / rms_ref))
    print(f"reference: B={B} loop on the card vs on the CPU: u max err "
          f"{u_err:.3e} of max|u| (tolerance 0.02), residual RMS max rel "
          f"err {rms_err:.3e} (tolerance 0.01)")
    if not np.allclose(rms, rms_ref, rtol=0.01, atol=5e-3) or u_err > 0.02:
        fail("the loop on the card disagrees with the CPU loop")


def main() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = device_phase()
    dev = torch.device("cuda:0")
    build_phase()
    stats = kernel_phase(dev, card)
    launches = slice_phase(dev, card)
    print(json.dumps({"kernels": [{
        "name": "psf_div3_sym", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES, "launches": launches, **stats}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
