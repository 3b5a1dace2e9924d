"""Drive the PyTorch port's paths once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one printed line or more each; any failure raises and exits
non-zero (so does a machine without CUDA, or a directory without the
package):

1. device: the card's name and power limit (nvidia-smi), torch and CUDA.
2. build: compile kernels B1-B5 (csrc/psf_div3_sym.cu, psf_div.cu,
   psf_crop.cu, psf_div3_sym_thin.cu, transc_sincos.cu, transc_cos.cu)
   with nvcc for sm_90a, one nvcc each, all started together; print each
   build's seconds and ptxas registers, shared memory and spills.  B1,
   B2, B3 and B4 (3xTF32 on the tensor cores: B1 on the wgmma engine
   csrc/psf_wgmma.cuh, B2-B4 on csrc/psf_mma.cuh's mma.sync), and their
   bf16 entries in the same libraries (one bf16 pass: B4's on
   psf_mma.cuh, B1-B3's on psf_wgmma.cuh): each kernel's registers,
   dynamic shared memory, spills and the tensor-core instructions in its
   SASS; a spill, an mma.sync float32 kernel without HMMA or with bf16
   ones, a bf16 mma.sync kernel without HMMA.16816.F32.BF16, or a wgmma
   kernel without its HGMMA (bf16 HGMMA.64xNx16.F32.BF16; TF32
   HGMMA.64xNx8.F32.TF32 for B1 float32) or with any HMMA, fails.
3. kernel: each kernel against its plain PyTorch version on the card.
   B1-B4 at R=128, B=4096 (the main path's shapes; B3 at N=12,288) with
   31-px crops and with 41- and 63-px ones (two crop bands of the
   engine), and at R=512, B=256, on speckled phases (std 0.4 rad) with
   the real defocus diversity; B2 also on a random 5-map stack, B3 on the
   total phases (rtol 2e-4; atol 1e-5 of the batch's PSF peak, because
   both sum R^2 unit-modulus field terms in float32 in different orders
   -- an error that scales with the peak amplitude).  B1 at 31 px within
   2.0e-6 of the peak at R <= 128 and 3.8e-6 at R=512 (the mma.sync
   design's errors, ROADMAP C.3), also at R=98, B=256 (4-byte copies),
   B=1 and B=5 (an odd count).  B1-B4's bf16
   entries at the same shapes against their plain versions' bf16 branch:
   atol 4e-5 of the peak on the real diversity (B1, B4, B2 on the triple,
   B3), 2e-4 on the 5 random maps (the tensor cores' stage-1 sums round
   toward zero and flip the bf16 rounding of a stage-1 element now and
   then), and at most 1/4 of the bf16 plain version's gap from the
   float32 one on the same inputs (the kernel computes the bf16
   function).  The 4e-5 must catch a B1 kernel that rounds its +- fields
   instead of its four products: B2's bf16 plain version on the triple
   rounds those fields, and at R=128 (31 px) it must miss B1's by more.
   B1-B3's bf16 entries also at R=98, B=256 (B2 on the triple and on
   the 5 random maps), whose rows (392 bytes) their engine copies in 4
   bytes, not by TMA.  B5a/B5b at (4096, 4096) and at the ragged (1000, 1000), k = 8 and 32,
   on the JAX script's inputs (all 0.7) and on seeded U(-3, 3) (atol
   1e-6: both chains contract, so rounding does not grow with k).
4. variants: the kernel A/B entry point (benchmarks/kernel_variants.py)
   at R=128, B=4096 -- the main path's shapes, B3 at N=12,288 -- and at
   R=512, B=256, in turns kernels, plain versions, kernels.  Its first
   run is the path that launches B4 and B4 bf16: every kernel must
   launch there.  Each time beside its bound (roofline.measure_bound:
   the least time at float32 accuracy, the DFT stages as 3 TF32 passes
   on the tensor cores; for the bf16 variants one bf16 pass) and, for
   the float32 variants, beside the FP32 bound (every FLOP on FP32).
   Then the kernels alone at R=128, B=4096 with 41- and 63-px crops,
   where every kernel must launch, each beside its bound at that width
   (none may exceed 105%).
5. slice: reference_config(resolution=128) cut as bench.py cuts it
   (n_train=300, n_valid=50, 25 steps, gauss_newton_iters=0): build on
   the card, 4096 shared-window scenarios, run_batch for 25 steps,
   measuring through each route of the estimator's switch -- B1 (the
   build's default), B2 (div_sym3 off), B3 (no diversity cos/sin maps).
   Then the same configuration with estimator.dft_dtype="bfloat16" (its
   own build) through the same three routes: the bf16 entries of B1-B3.
   Each run must launch its kernel >= 25 times (a bf16 run its bf16
   entry, and the float32 entry 0 times), give finite outputs and a
   settled exact Strehl >= 0.975, within 0.002 of the float32 B1 run's;
   then the best of 3 timed runs, the six runs in turns.  The same loop
   at B=4 with injected noise on the card and on the CPU (plain
   versions) must agree on every run (residual RMS rtol 0.01, u atol
   0.02 max|u|, as tests/test_golden_trajectory.py).
6. trace: one torch.profiler trace of a 25-step B1 run, right after the
   timed runs: device busy time, the idle share of the traced run, and
   the top device kernels and ops.
7. wide: the same configuration with estimator.crop_half=20 (41-px
   crops; its own build) through B1: 25 steps at B=4096 must launch B1
   25 times and settle at exact Strehl >= 0.975, the B=4 card-vs-CPU
   check must pass, and its run time stands beside the 31-px run's
   (best of 3, in turns).
8. loop R=512: the bench configuration at R=512, B=256 (its own build),
   25 steps through B1 and through B2: both keep lock and settle within
   0.002 of each other in exact Strehl; the B=4 card-vs-CPU check of
   the slice phase, through B1.
9. strong: the strong-turbulence recipe (ROADMAP A.7; config.
   strong_turbulence: radial order 10, mmse estimator with the analytic
   Von Karman prior, warm start, var_ridge 1e-2, r_weight 30) at R=512,
   D/r0=10, the sim defaults, 500 steps, 256 shared-window scenarios (64
   at each SNR of 5, 10, 20, 40 dB), from pipeline.warm_start_command:
   MONTECARLO512_r05.json's D/r0=10 block.  Per SNR the settled (steps
   250:) exact Strehl, its p10 and the diverged count (non-finite, or a
   residual over 10x the turbulence RMS), beside the JAX target
   0.9334-0.9338; each must reach 0.92 with 0 diverged, and B1 must
   launch >= 2 times a step.  A 10-step window of the run (the same
   build, untraced and then traced once, trace_run) gives B1's share of
   device busy beside the 500-step trace's 60.3% (PERF.md §5), and
   the B=4 card-vs-CPU check of the slice phase passes on it.  Then the
   tracking estimator (track_gn_iters=1) with the estimator-VAR fusion
   (est_gain 0.9, innovation_gate 5) at R=128, D/r0=15, B=64, 60 steps:
   finite, B1 >= 4 launches a step in the first run, then 3 warm runs
   timed (median and range a step), and the card-vs-CPU check at 10
   steps.  The phase ends on the seconds of each of its parts: builds,
   runs, the trace's run, stop and export, and key_averages, and each
   reference check's card and CPU halves.
10. solvers: every solver of the loop's switch through B1 (ROADMAP A.8),
   each run counted (B1 launches exactly steps x (1 + Gauss-Newton
   passes), and each solver -- solve_fixed, solve, banded_solve (cyclic
   reduction), admm_condensed -- called exactly as often as the run's
   branch calls it: once a step, banded_solve once a Newton step) and
   then timed warm: (a) the bench configuration of the slice phase (its
   build), B=4096, 25 steps, through the general Newton solve
   (newton_steps=2: within 0.002 of the slice phase's fixed-step B1
   run's settled exact Strehl) and ADMM (400 iterations: settled
   residual RMS within 0.1 rad of the fixed step's, max|du[1:]| <= 1.05
   du_max); (b) BASELINE config 1 (tests/test_configs.py:26-39): VAR(1)
   with the ramp rows (fastmpc_ramp), R=128, its own build, B=1024, 60
   steps (A2 = 0, max|du| <= 1.01 du_max, the residual over the last 10
   steps below 0.75x the turbulence); (c) MODES_r04.json's order-10 N=32
   cells: radial order 10, the high-order recipe, N=32 through
   with_horizon, B=64, 200 steps from the warm start, fixed and
   general_cr (newton_steps=2: cyclic reduction), each within 0.003 of
   its quality target (0.9846, 0.9847) with 0 diverged.  The B=4
   card-vs-CPU check passes on newton_steps=2, ADMM (3 steps), the ramp
   loop and general_cr (20 steps).  A 1-step ADMM run and a 5-step
   general_cr run are traced (trace_run).  The phase ends on the seconds
   of its parts.
11. edge: the conditional-Gaussian flow (ROADMAP A.9) in the JAX
   protocol (benchmarks/protocol_edge.py:150-200, RESULTS_EDGE_r05.json):
   reference_config(512) with flow="conditional", n_train 1000, n_valid
   50, 500 steps, through B1.  One build, its seconds by part (extension
   operators, initial screens, rollout); the reference rows from the
   build's state (shared turbulence over D/r0 5, 10, 15, 20; D/r0=5
   held to 0.975), timed warm; the B=32 Monte-Carlo at D/r0=5 (held to
   0.975); per-scenario turbulence from 8 batch_states start states,
   each at the 4 D/r0 (B=32): the median held to 0.975 / 0.94 / 0.89 at
   D/r0 = 5 / 10 / 15 (lock at D/r0 >= 10 depends on the start state),
   and at D/r0=5 every residual below half the turbulence over the last
   20 steps; B1 launches exactly 1 + gauss_newton_iters times a step in
   every run; the operator stream (24 border draws a step, CUDA events,
   against the floor of their bytes at the published HBM rate) and a
   whole advance; a 10-step window traced (B1's, the GEMM/GEMV kernels'
   and the copy kernels' shares of busy); the B=4 card-vs-CPU check
   with injected border normals.
12. parallel: the scenario-sharded runner (ROADMAP A.10) through B1 on
   the slice phase's build and batch (R=128, B=4096, 25 steps, verified
   shared window): (a) a world of one rank under NCCL on cuda:0 --
   run_sharded's statistics within rtol 1e-4 of run_batch's reduction
   of the same batch (tests/test_parallel.py:63-68), a scenario with a
   NaN magnification counted in n_diverged and kept out of the means,
   dryrun_multichip(1); (b) two spawned ranks sharing cuda:0 over gloo,
   each restoring the build from a checkpoint, run_sharded over the same
   4096 scenarios (2048 a rank) within rtol 1e-4 of (a)'s one-process
   statistics.  B1 launches exactly 25 times in (a) and in each rank;
   warm ms a step of (a) and (b).
13. population: the port's benchmarks/montecarlo_100k.py at R=128, all
   16 cells (D/r0 5/10/15/20 x SNR 5/10/20/40), 800 reps a cell in
   chunks of 400 (B=1600), 100 steps: 12,800 scenarios through B1
   (exactly 100 x (1 + gauss_newton_iters) launches a chunk: 200), each
   cell's mean / p10 settled exact
   Strehl and diverged count beside MONTECARLO_r04.json's (0 diverged,
   mean within 0.003), build seconds a D/r0, loop seconds, solves/s;
   then the D/r0=5 part stopped after one chunk (MC1_STOP_AFTER=1) and
   resumed from its checkpoint: summaries bit-identical to the
   uninterrupted run's.
14. classical: the port's benchmarks/classical_vs_mpc.py (the JAX
   script's comparison of the classical Shack-Hartmann + TSVD integrator
   loop with the sensorless MPC loop on one frozen-flow window) at its
   own size: R=128, D/r0 5 and 10, 500 steps, n_train/n_valid 1000/500,
   the strong recipe at D/r0=10, SH with 8 lenslets (128 is not a
   multiple of 10), gains 0.3/0.5/0.7, an ideal and a noise-matched
   integrator row.  Held to CLASSICAL_r05.json: the MPC's settled exact
   Strehl within 0.003 (0.9728 / 0.9527), the ideal integrator's best
   gain 0.7 with its residual within 1% (0.1747 / 0.3013), the
   noise-matched residual within 3% (0.1845 / 0.3388), both MPC
   advantages > 1; B1 launches exactly 500 x (1 + gauss_newton_iters) a
   row, none in the build.  Then the card against the CPU (TF32 off):
   the integrator on a 50-step window with one injected slope-noise
   tensor (c_acc, rms within rtol 1e-4), the SH geometric, diffractive
   and camera slopes at R=128 and the pyramid's at R=64 with modulation
   0 and 3 (1e-4 of their peak), and imaging.read_out's photon, QE and
   readout noise on a cuda generator held to tests/test_imaging.py's
   mean and variance.  Prints build s, MPC and integrator ms a step, SH
   and pyramid ms a call at B=1; the report goes to
   chiprun_out/classical_vs_mpc.json.
15. a12: the wavefront-sensing and MCAO slice (ROADMAP A.12), which
   launches no PSF kernel (every count 0 after it). (a) The port's
   examples/wfs_demo.py and mcao_demo.py on the card, held to the JAX
   demos' numbers in mpc_sensorlessao_tpu_torch/examples/
   demo_reference.json: the MCAO variances rtol 1e-6, the 60-screen
   Monte-Carlo residual 1e-3, the tomography error and Strehl 1e-4, the
   slopes-MMSE map RMS 1% (a float32 CG at tol 5e-2 is not reproducible
   to rounding; a model without its cross covariance reads 11% off,
   tests/test_torch_demos.py). (b) A 40x40 SH at R=320 (8 px a lenslet),
   512 frames, each a 720-px window of a numpy-seeded FFT screen (no
   subharmonics) seen as each system sees it: on axis (NGS), projected
   into the three guide stars' directions (3-GS tomographic, 15"
   triangle, 8 km layer) and onto the cone of an LGS at H = 90 km (8 km
   layer); the demo's noise (0.02 px), tol 5e-2.  For each
   reconstructor: CG depth, ms a batch (CUDA events), every frame's true
   residual (float64) within 1.2 x tol, and card against CPU on 16
   frames: at a fixed depth of 4 iterations 1e-4 of each map's RMS, and
   at tol 5e-2 each card answer a solution of the CPU's system to 1.2 x
   tol (float64).  A control -- the NGS model with twice the noise
   variance -- must fail that last check.  (c) Card against CPU (1e-5
   of the peak): relay.project_layers on 8 screen pairs off-axis and
   through an LGS cone, lgs.elongate_spots with kw 8 and 9,
   raytrace.trace on 10^6 rays.  Report in chiprun_out/a12.json, one
   summary line.
16. protocol: the port's experiment protocols and timers
   (benchmarks/protocol_sweep.py, excursion_tail.py, protocol_edge.py,
   modes_horizon.py, montecarlo_sweep.py, full_protocol.py,
   latency_b1.py, solver_throughput.py, long_horizon.py,
   cholesky_paths.py) through B1, held to the JAX records; every run
   counted (B1 exactly steps x (1 + gauss_newton_iters) a run, none in a
   build).  (a) protocol_sweep at R=512, n_train 1000 / n_valid 50, 500
   steps (RESULTS_r05.json): the reference rows (one build, D/r0 5, 10,
   15, 20 as a scenario axis) -- D/r0=5 held by the 8-seed rule below,
   D/r0 >= 10 must collapse as the JAX rows and the float64 oracle do
   (rejection < 1.2, crop flag false) -- and the tuned rows at D/r0 5
   and 15 (one build a D/r0; 10 and 20 are cut for time), each run on
   the script's own noise stream and, on the same build, over 8 noise
   seeds in one batched run: the JAX row within the seeds' [min, max]
   widened by 0.005 (D/r0 5) or 0.02 (15);
   each tuned row finite with rejection > 1.2; its float64 VAR RMSE and
   RRMSE printed beside the JAX float32 ones (ROADMAP C.4).
   (b) excursion_tail at D/r0=15 (RESULTS_TAIL_r05.json): the order-10
   arm is (a)'s tuned D/r0=15 run (the same configuration); the order-14
   clamp arm (var_max_radius 0.85) runs, its peak device allocation
   printed: its verdict "improved" must be the JAX one and its mean
   Strehl within 0.02 of the JAX arm's; D/r0=20 is cut.  (c)
   protocol_edge's tuned stage at D/r0 10 (5 is cut for time; the edge
   phase holds D/r0=5 on this flow) on the conditional flow
   (RESULTS_EDGE_r05.json): the row from the build's state, and the
   median over 4 batch_states start states, each from its own warm
   start (two open-loop steps), held within 0.02 of the JAX row;
   its ref / mc stages are the edge phase's, its periodic stage (a)'s
   reference rows.  (d) modes_horizon at R=128, B=64, 200 steps, orders
   6 and 14 (order 10 is the solvers phase's), N = 2, 8, 32, fixed and
   at N=32 general_cr, each a warm-up and a timed run, solver calls
   counted (count_solver_calls): every N=32 cell within 0.003 of
   MODES_r04.json, 0 diverged.  (e) montecarlo_sweep at R=512, D/r0=5,
   4 SNRs x 64, 500 steps: each cell within 0.003 of
   MONTECARLO512_r05.json's, 0 diverged.  (f) full_protocol at R=128,
   B=32 (the 1000/500/500 split): within 0.003 of CLASSICAL_r05.json's
   MPC row of the same configuration, health OK.  (g) latency_b1 at
   R=128 and 512, 200 steps, 3 timed runs (the script's default is 9),
   BENCH_GN=0: CUDA-event and host-clock ms a step, exactly one B1
   launch a step.  (h) the solver timers at their
   defaults (solves/s), and their solves at B=4 on the card against the
   CPU (rtol 1e-4, atol 1e-4 of the scale).  Report in
   chiprun_out/protocol.json and chiprun_out/latency_b1.json.
17. tools: the port's bench, step and flow timers, scaling report and
   float64 oracle rows through their main(argv, env), B1 launches counted
   exactly a run (none in a build).  (a) benchmarks/bench.py at its
   defaults (R=128, B=4096, 25 steps, 3 timed runs): its one stdout line,
   reprinted as "bench: <line>"; settled exact Strehl >= 0.975 and within
   0.001 of the slice phase's float32 B1 run (the same configuration,
   build and scenarios); B1 exactly 25 x (1 + 3) launches.  (b)
   step_breakdown.py and step_knockouts.py at R=512, B=256, 25 steps:
   the four stages, the whole step, the sum of parts and all eleven
   knockout variants in us a step a scenario (CUDA events).  (c)
   edge_flow_cost.py at R=128, 200 steps (its default 500): both flows,
   each settled at exact Strehl >= 0.9.  (d) edge_flow_breakdown.py at
   R=128, 3 timed runs a row (its default 9): the
   advance breakdown rows and the closed loop at B=1 and 64 by CUDA
   events and the host clock, the JAX rows not ported.  (e) scaling.py
   with worlds of 1 and 2 gloo ranks sharing cuda:0 (cross_card false):
   B1 launches exactly steps x (1 + gauss_newton_iters) in each rank.
   (f) oracle_reference_rows.py cut to R=64, 20 steps: finite rows,
   D/r0=5 not collapsed.  (g) The whole step (run_batch) and the
   knockouts' replica of it (telemetry "stacked") at R=512, B=256 in
   turns, then one traced run of each (busy, idle, top kernels, kernel
   launches and host CPU time), and one traced 25-step run of the flow's
   advance and of its integer-lattice part (no_frac) at R=128.  Reports
   in chiprun_out/tools.json,
   edge_flow_breakdown.json, scaling.json and oracle_r64.json.
18. peaks: the device-peaks entry point (benchmarks/device_peaks.py), the
   path of B5a/B5b: every measured ceiling beside the card's name and
   power limit; each kernel must launch >= k1 + k2 times, and no rate may
   exceed 105% of its published peak.
19. roofline: rows of the roofline entry point (benchmarks/roofline.py)
   on the slice's build -- B1 at R=128 B=4096 and R=512 B=256, the step
   at R=128 B=4096 with 0 and 1 Gauss-Newton iterations, solve_fixed
   N=2 B=1024 -- each as a share of the published and of the measured
   peaks, B1's DFT stages against TF32 (none may exceed 105%); B1-B4 and
   the bf16 variants against their bound at the measured ceilings (none
   may exceed 105%), the float32 ones beside the measured-FP32 bound
   (every FLOP on FP32; no bound for bf16 products).
20. one JSON line listing the kernels -- B1-B5b, then the bf16 entries
   psf_div3_sym_bf16, psf_div_bf16, psf_crop_bf16, psf_div3_sym_thin_bf16
   (bound_ms and bound_by from measure_bound at the published peaks,
   fp32_bound_ms beside them, null for the bf16 entries; B1's launches
   in the strong and tracking runs as launches_strong and
   launches_tracking, in the solvers phase's runs as "launches_solvers
   <run>", in the edge phase's as "launches_edge <run>", in the parallel
   and population phases' as "launches_parallel <run>" and
   "launches_population <run>", in the classical rows as
   "launches_classical d=<D/r0>", in the protocol phase's runs as
   "launches_protocol <run>", in the tools phase's as "launches_tools
   <run>")
   -- then the last line {"ok": true, "device": {...}}.
"""

import concurrent.futures
import contextlib
import dataclasses
import io
import json
import os
import re
import shutil
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
from torch.autograd import DeviceType

from mpc_sensorlessao_tpu_torch import reference_config, strong_turbulence
from mpc_sensorlessao_tpu_torch.benchmarks import _protocol, bench
from mpc_sensorlessao_tpu_torch.benchmarks import cholesky_paths
from mpc_sensorlessao_tpu_torch.benchmarks import classical_vs_mpc
from mpc_sensorlessao_tpu_torch.benchmarks import device_peaks
from mpc_sensorlessao_tpu_torch.benchmarks import edge_flow_breakdown
from mpc_sensorlessao_tpu_torch.benchmarks import edge_flow_cost
from mpc_sensorlessao_tpu_torch.benchmarks import excursion_tail
from mpc_sensorlessao_tpu_torch.benchmarks import full_protocol, latency_b1
from mpc_sensorlessao_tpu_torch.benchmarks import kernel_variants, roofline
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
from mpc_sensorlessao_tpu_torch.examples import mcao_demo, wfs_demo
from mpc_sensorlessao_tpu_torch.models import closed_loop, estimator
from mpc_sensorlessao_tpu_torch.models import imaging, integrator, pipeline
from mpc_sensorlessao_tpu_torch.models import lgs, pyramid, slopes_mmse
from mpc_sensorlessao_tpu_torch.models import solvers, wfs
from mpc_sensorlessao_tpu_torch.ops import block_tridiag, cuda_build, dft
from mpc_sensorlessao_tpu_torch.ops import edge_flow, newton_kkt, psf
from mpc_sensorlessao_tpu_torch.ops import phase_screens, raytrace, relay
from mpc_sensorlessao_tpu_torch.ops import psf_kernels
from mpc_sensorlessao_tpu_torch.ops import zernike
from mpc_sensorlessao_tpu_torch.parallel import dryrun, montecarlo
from mpc_sensorlessao_tpu_torch.parallel import mesh as mesh_lib
from mpc_sensorlessao_tpu_torch.parallel import multihost
from mpc_sensorlessao_tpu_torch.utils import profiling, tree
from mpc_sensorlessao_tpu_torch.utils.config import AtmosphereConfig, mag_conv

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
# (name, library, wrapper, plain version, bf16 branch it replaces, variant
# of the A/B entry point, loop route) of the bf16 entries of B1-B4
BF16_KERNELS = (
    ("psf_div3_sym_bf16", "psf_div3_sym", K.psf_crop_diversity_sym3,
     K.psf_crop_diversity_sym3_ref, f"{PALLAS}:134", "sym3_bf16", "sym3"),
    ("psf_div_bf16", "psf_div", K.psf_crop_diversity,
     K.psf_crop_diversity_ref, f"{PALLAS}:85", "general_bf16", "general"),
    ("psf_crop_bf16", "psf_crop", K.psf_crop_intensity,
     K.psf_crop_intensity_ref, f"{PALLAS}:34", "unfused_bf16", "unfused"),
    ("psf_div3_sym_thin_bf16", "psf_div3_sym_thin",
     K.psf_crop_diversity_sym3_thin, K.psf_crop_diversity_sym3_thin_ref,
     f"{PALLAS}:193", "sym3_thin_bf16", None),
)
BF16 = "bfloat16"
BF16_HMMA = "HMMA.16816.F32.BF16"
# the bf16 and TF32 warpgroup products (wgmma) of the wgmma engine's
# entries, any N
BF16_HGMMA = re.compile(r"\bHGMMA\.64x\d+x16\.F32\.BF16\b")
TF32_HGMMA = re.compile(r"\bHGMMA\.64x\d+x8\.F32\.TF32\b")
# bf16 entries on the wgmma engine csrc/psf_wgmma.cuh (B4's runs
# csrc/psf_mma.cuh's bf16 mma.sync)
WGMMA_ENTRIES = ("psf_div3_sym_bf16", "psf_div_bf16", "psf_crop_bf16")
# every entry on the wgmma engine, with the products its SASS must show:
# the bf16 entries, and B1's float32 one in 3xTF32 (B2-B4's run
# psf_mma.cuh's TF32 mma.sync)
HGMMA_OF = {**{e: BF16_HGMMA for e in WGMMA_ENTRIES},
            "psf_div3_sym": TF32_HGMMA}
# B1 float32's max error against its plain version, of the peak, at
# R <= 128 and at R=512: the mma.sync design's (ROADMAP C.3), which the
# wgmma design must keep
B1_F32_ATOL = {128: 2.0e-6, 512: 3.8e-6}
# (R, B) of B1 float32's extra checks: the ragged grid (4-byte copies),
# one scenario and an odd count (a consumer with nothing to store)
B1_F32_SHAPES = ((98, 256), (128, 1), (128, 5))
# bf16 entry against bf16 plain, of the peak: the tensor cores' stage-1
# sums (rounded toward zero, not to nearest) flip the bf16 rounding of a
# stage-1 element now and then.  At R=128, B=4096 that moves a pixel by
# 1.9e-5 of the peak on the real diversity and 1.16e-4 on the 5 random
# maps' speckle, as a CPU emulation of that accumulation reproduces
# (tests/test_torch_ops.py); a B1 kernel that rounded its +- fields would
# miss by more than 6e-5, which BF16_ATOL catches.
BF16_ATOL = 4e-5
BF16_ATOL_RANDOM_MAPS = 2e-4
# (label, library) of the kernels on the tensor-core engine
MMA_KERNELS = (("B1", "psf_div3_sym"), ("B2", "psf_div"), ("B3", "psf_crop"),
               ("B4", "psf_div3_sym_thin"))
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
# estimator.crop_half of the wide-crop loop: 41-px crops, two crop bands
WIDE_CROP_HALF = 20
DIVERSITY_AMP = 3.0
STEPS = 25
BATCH = 4096
# (R, B) of the kernel checks and timings: the main path's, and R=512
SHAPES = ((128, BATCH), (512, 256))
# crop widths beside the main path's 31 px at R=128: 41 (crop_half 20) and
# 63 (31), two crop bands, in the kernel checks and the A/B
WIDE_CROPS = (41, 63)
# (R, B, crop_half) of the kernel checks
KERNEL_SHAPES = ((128, BATCH, CROP_HALF),
                 *((128, BATCH, (w - 1) // 2) for w in WIDE_CROPS),
                 (512, 256, CROP_HALF))
# (R, B) of the wgmma engine's bf16 entries at a ragged R: rows of 392
# bytes, not a multiple of 16, which the engine copies in 4 bytes, not by
# TMA
RAGGED_BF16 = (98, 256)
# (R, B) of the R=512 loop through B1 and B2 (ROADMAP C.3)
LOOP_512 = (512, 256)
MIN_STREHL = 0.975
# settled exact Strehl of a loop that keeps lock (one that lost it falls
# to <= 0.9): the R=512 loop's floor
LOCK_STREHL = 0.9
ROUTE_STREHL_TOL = 0.002
# the strong-turbulence recipe run (ROADMAP A.7): MONTECARLO512_r05.json's
# D/r0=10 block -- R=512, 500 steps, 64 scenarios at each SNR -- whose
# JAX settled exact Strehl is 0.9334-0.9338 per SNR with 0 diverged
STRONG_R = 512
STRONG_D = 10.0
STRONG_STEPS = 500
STRONG_REPS = 64
STRONG_SNRS = (5.0, 10.0, 20.0, 40.0)
STRONG_MIN_STREHL = 0.92
# the strong run's trace: a window of its first steps, and B1's share of
# device busy in the whole 500-step trace (PERF.md §5)
STRONG_TRACE_STEPS = 10
B1_SHARE_500 = 60.3
JAX_STRONG = (0.9334, 0.9338)
# the solvers phase (ROADMAP A.8): ADMM's limits against the fixed step
# (tests/test_closed_loop.py:58-60, 83-89); BASELINE config 1's ramp loop;
# MODES_r04.json's order-10 N=32 cells, whose settled exact Strehl (fixed
# 0.9846, general_cr 0.9847) does not depend on the platform
ADMM_RES_TOL = 0.1
ADMM_DU_SLACK = 1.05
# ADMM's card-vs-CPU check and trace run fewer steps: each step is 400
# iterations of ~25 launches (25 steps took 17.4 s on the CPU side, and
# key_averages() of a 2-step trace 8.9 s); so does the general_cr trace.
# Three steps still reach the ramp bounds shifted by a nonzero u1 (steps
# 1 and 2)
ADMM_REF_STEPS = 3
ADMM_TRACE_STEPS = 1
MODES_TRACE_STEPS = 5
RAMP_BATCH = 1024
RAMP_STEPS = 60
MODES_BATCH = 64
MODES_STEPS = 200
MODES_REF_STEPS = 20
MODES_TARGET = {"fixed": 0.9846, "general_cr": 0.9847}
MODES_STREHL_TOL = 0.003
# (R, D/r0, B, steps) of the tracking and fusion run
TRACK = (128, 15.0, 64, 60)
TRACK_TIMED = 3             # warm tracking runs timed after the counted one
# the edge phase (ROADMAP A.9): the conditional-Gaussian flow in the JAX
# protocol of benchmarks/protocol_edge.py:150-200 (RESULTS_EDGE_r05.json):
# reference_config(512), n_train 1000, n_valid 50, 500 steps; the
# reference rows share one realization over the D/r0 grid
EDGE_R = 512
EDGE_STEPS = 500
EDGE_D_GRID = (5.0, 10.0, 15.0, 20.0)
# settled exact Strehl floors at D/r0 = 5, 10, 15, below the JAX rows'
# 0.9848 / 0.9527 / 0.9082 (one realization); D/r0=20 is printed, not
# held: the reference collapses there too (0.0257).  Whether the 28-mode
# LS loop acquires lock at D/r0 >= 10 depends on the realization it
# starts from (PERF.md §6, benchmarks/edge_realizations.py: from the
# build's own state at the test split none of 10 border-noise streams
# locked at D/r0=10, from 8 other start states 7 did), so D/r0 = 10 and
# 15 are held on the median over EDGE_REALIZATIONS independent start
# states, and D/r0=5 on every run
EDGE_MIN_STREHL = {5.0: 0.975, 10.0: 0.94, 15.0: 0.89}
JAX_EDGE = {5.0: 0.9848, 10.0: 0.9527, 15.0: 0.9082, 20.0: 0.0257}
# the Monte-Carlo batch at D/r0=5 (JAX 0.9848), shared turbulence
EDGE_MC_BATCH = 32
EDGE_MC_MIN_STREHL = 0.975
# per-scenario turbulence: independent start states from batch_states,
# each run at every D/r0 of the grid with its own border noise; at D/r0=5
# the residual over the last EDGE_PS_LAST steps stays below half the
# turbulence in every one
EDGE_REALIZATIONS = 8
EDGE_PS_LAST = 20
EDGE_TRACE_STEPS = 10
EDGE_REF_STEPS = 3
EDGE_STREAM_STEPS = 20      # advances timed for the operator stream
# name patterns of device kernels, for the shares of the edge trace
EDGE_TRACE_SHARES = {
    "B1 (psf_div3_sym_kernel)": r"\bpsf_div3_sym_kernel\b",
    "GEMM and GEMV kernels (the border draws and the loop's products)":
        r"gemm|gemv|Gemm|Gemv|xmma|cutlass",
    "copy, cat and index kernels": r"[Cc]opy|[Cc]at|[Ii]ndex|gather|scatter",
}

# the parallel phase (ROADMAP A.10): the sharded runner's statistics held
# to run_batch's over the same scenarios (tests/test_parallel.py:63-68)
PARALLEL_RTOL = 1e-4
PARALLEL_RANKS = 2          # gloo ranks sharing cuda:0
PARALLEL_TIMED = 2          # warm runs timed after the counted one
PARALLEL_DIR = Path(__file__).resolve().parent / "build" / "parallel"
# the population phase: the port's benchmarks/montecarlo_100k.py at
# R=128, all 16 cells of MONTECARLO_r04.json, cut to 800 reps a cell in
# chunks of 400 (B=1600 a chunk); each cell's settled mean exact Strehl
# within 0.003 of that file's, 0 diverged; the D/r0=5 part stopped after
# one chunk and resumed, bit-identical to the uninterrupted run
POPULATION_R = 128
POPULATION_ENV = {"MC1_DEVICE": "cuda", "MC1_DR0": "5,10,15,20",
                  "MC1_SNR": "5,10,20,40", "MC1_REPS": "800",
                  "MC1_CHUNK": "400", "MC1_STEPS": "100"}
POPULATION_REF = Path(__file__).resolve().parent / "MONTECARLO_r04.json"
POPULATION_TOL = 0.003
# the classical phase: benchmarks/classical_vs_mpc.py at the JAX script's
# own size, held to its quality numbers (CLASSICAL_r05.json; only its times
# depend on the platform)
CLASSICAL_REF = Path(__file__).resolve().parent / "CLASSICAL_r05.json"
CLASSICAL_R = 128
CLASSICAL_STEPS = 500
CLASSICAL_D = (5.0, 10.0)
CLASSICAL_STREHL_TOL = 0.003     # MPC: only the estimator's noise stream differs
CLASSICAL_IDEAL_RTOL = 0.01      # noiseless integrator: deterministic
CLASSICAL_NOISY_RTOL = 0.03      # noise-matched: another stream, same law
CLASSICAL_GAIN = 0.7
CLASSICAL_CPU_STEPS = 50
CLASSICAL_RTOL = 1e-4            # card vs CPU
PYRAMID_R = 64
PYRAMID_NL = 16
# a12: the wavefront-sensing and MCAO slice (ROADMAP A.12)
A12_REF = (Path(__file__).resolve().parent / "mpc_sensorlessao_tpu_torch"
           / "examples" / "demo_reference.json")
A12_ANALYTIC_RTOL = 1e-6         # MCAO variances: host float64
A12_MC_RTOL = 1e-3               # the 60-screen Monte-Carlo residual
A12_TOMO_RTOL = 1e-4             # tomography error and Strehl
A12_CG_RMS_RTOL = 0.01           # the demo's map RMS (PERF.md §6)
A12_R = 320                      # 40x40 lenslets of 8 px
A12_NL = 40
A12_BATCH = 512
A12_WINDOW = 720                 # screens of 1440 px cut 2 x 2
A12_TOL = 5e-2
A12_MAXIT = 100
A12_CPU_FRAMES = 16
A12_DEPTH = 4                    # the fixed CG depth held at 1e-4
A12_MAP_RTOL = 1e-4              # card vs CPU at the fixed depth
A12_RESIDUAL_SLACK = 1.2         # true residual <= slack x tol (float32)
A12_LGS_H = 90e3
A12_RAYS = 1_000_000
# the protocol phase: the port's experiment protocols at the JAX records'
# sizes, held to those records (RESULTS_r05.json, RESULTS_EDGE_r05.json,
# RESULTS_TAIL_r05.json, MODES_r04.json, MONTECARLO512_r05.json).  The
# screens come from numpy seeds, so the turbulence is the JAX one; the
# measurement noise (and the conditional flow's border draws) come from
# torch generators, so a single row is held to the spread over noise seeds
ROOT = Path(__file__).resolve().parent
PROTO_R = 512
PROTO_TRAIN = 1000                      # the records' split: 1000 / 50
PROTO_STEPS = 500
PROTO_D = (5.0, 10.0, 15.0, 20.0)
# the tuned rows, one R=512 build each: the ends of the lock range the
# records hold them to (D/r0=15 is also the excursion's order-10 arm)
PROTO_TUNED_D = (5.0, 15.0)
PROTO_SEEDS = 8
# the JAX row must lie within the card's seed range widened by this
PROTO_WIDEN = {5.0: 0.005, 10.0: 0.005, 15.0: 0.02, 20.0: 0.02}
PROTO_LOCK_REJECTION = 1.2
PROTO_EDGE_D = (10.0,)                  # lock depends on the start state
PROTO_EDGE_STATES = 4
PROTO_EDGE_TOL = {5.0: 0.01, 10.0: 0.02}
PROTO_MODES_ORDERS = (6, 14)            # order 10 is the solvers phase's
MODES_R = 128
PROTO_MODES_TOL = 0.003
PROTO_MC_D = 5.0
PROTO_MC_TOL = 0.003
PROTO_TAIL_D = 15.0
PROTO_TAIL_TOL = 0.02
# full_protocol's defaults: reference_config(128), the 1000/500/500
# split, B=32.  That loop is CLASSICAL_r05.json's MPC row at D/r0=5 (the
# same configuration, one scenario): held within CLASSICAL_STREHL_TOL of
# it.  (The slice phase's MIN_STREHL is a floor for the 300/50 bench cut;
# this split settles below it, in JAX too: 0.9728)
PROTO_FULL = (128, 32)
PROTO_LATENCY_ENV = {"LAT_RES": "128,512", "LAT_STEPS": "200",
                     "LAT_REPEATS": "3", "BENCH_GN": "0"}
# the solver timers' arguments (their defaults) and the card-vs-CPU batch
PROTO_TIMER_ARGS = {"solver_throughput": [], "long_horizon": [],
                    "cholesky_paths": []}
PROTO_SOLVER_B = 4
A12_RTOL = 1e-5                  # card vs CPU, of the peak
# the tools phase (the port's bench, step and flow timers, scaling and the
# float64 oracle rows)
BENCH_REPEATS = 3                # bench.py's default
BENCH_STREHL_TOL = 0.001         # the bench vs the slice phase's B1 run
TOOLS_EDGE_R = 128
TOOLS_EFC_STEPS = 200            # edge_flow_cost's loop steps (its default 500)
TOOLS_EFB_REPEATS = 3            # edge_flow_breakdown's timed runs a row
SCALING_ENV = {"SCALING_DEVICE": "cuda:0", "SCALING_RANKS": "2"}
ORACLE_ENV = {"ORACLE_RES": "64", "ORACLE_STEPS": "20",
              "ORACLE_TRAIN": "300"}
OUT_DIR = Path(__file__).resolve().parent / "chiprun_out"


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def reset_launches() -> None:
    for _, wrapper, *_ in KERNELS + CHAINS:
        wrapper.launches = 0
    for _, _, wrapper, *_ in BF16_KERNELS:
        wrapper.launches_bf16 = 0


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
    for label, lib in MMA_KERNELS:
        mma_resources(label, lib, results[names.index(lib)][1])


def mma_resources(label: str, lib: str, log: str) -> None:
    """Registers, stack and spills (ptxas) of a tensor-core library's
    kernels, and of its float32 and bf16 kernel the dynamic shared memory
    and HMMA count (their SASS); fails on a spill, on an mma.sync float32
    kernel without HMMA or with bf16 ones, on a bf16 mma.sync kernel
    without bf16 HMMA, or on a kernel of HGMMA_OF (the wgmma engine's)
    without its HGMMA (bf16, or TF32 for B1 float32) or with any HMMA."""
    res = cuda_build.ptxas_resources(log or cuda_build.ptxas_report(lib))
    funcs = device_peaks.sass_functions(device_peaks.sass(lib))
    for fn, r in res.items():
        print(f"build: {label} {fn}: {r['registers']} registers, "
              f"{r['stack']} B stack, {r['spill_stores']} B spill stores, "
              f"{r['spill_loads']} B spill loads")
        if r["spill_stores"] or r["spill_loads"]:
            fail(f"{label} kernel {fn} spills: {r}")
    for entry in (lib, f"{lib}_bf16"):
        sass = "".join(t for fn, t in funcs.items() if f"{entry}_kernel" in fn)
        hmma = len(re.findall(r"\bHMMA\.", sass))
        bf16 = sass.count(BF16_HMMA)
        smem = getattr(cuda_build.load(lib), f"{entry}_smem_bytes")()
        if entry in HGMMA_OF:
            kind = "bf16" if entry.endswith("_bf16") else "TF32"
            hgmma = len(HGMMA_OF[entry].findall(sass))
            print(f"build: {label} {entry}_kernel: {smem} B dynamic shared "
                  f"memory a block at R=128; {hgmma} {kind} HGMMA (wgmma) "
                  f"and {hmma} HMMA instructions in its SASS")
            if hgmma == 0 or hmma:
                fail(f"{label}'s {entry}_kernel shows {hgmma} {kind} HGMMA, "
                     f"{hmma} HMMA; ptxas {res}")
            continue
        print(f"build: {label} {entry}_kernel: {smem} B dynamic shared "
              f"memory a block; {hmma} HMMA (tensor-core) instructions in "
              f"its SASS, {bf16} of them {BF16_HMMA}")
        if hmma == 0 or (bf16 > 0) != entry.endswith("_bf16"):
            fail(f"{label}'s {entry}_kernel shows {hmma} HMMA, {bf16} "
                 f"{BF16_HMMA}; ptxas {res}")


def b1_args(R: int, B: int, dev, crop_half: int = CROP_HALF):
    """Seeded speckled phases (std 0.4 rad per pixel) with the real
    defocus diversity, pupil, the operator of a (2 crop_half + 1)-px crop
    and PSF scale of the estimator."""
    rng = np.random.default_rng(0)
    phase = torch.as_tensor(
        (rng.normal(size=(B, R, R)) * 0.4).astype(np.float32), device=dev)
    z4 = zernike.make_basis(6, R, device=dev).stack[4]
    scale = float((6.5e-6 * 512.0 / R) ** 4 * 1e12)
    return (phase, psf.pupil_mask(R, device=dev),
            torch.cos(DIVERSITY_AMP * z4), torch.sin(DIVERSITY_AMP * z4),
            dft.centered_partial_dft(R, crop_half, device=dev), scale)


def kernel_cases(R: int, B: int, dev, crop_half: int = CROP_HALF):
    """(label, library, arguments, bf16 atol of the peak) of every
    kernel check at (R, B) and crop_half."""
    phase, pupil, cos_a, sin_a, op, scale = b1_args(R, B, dev, crop_half)
    z4 = zernike.make_basis(6, R, device=dev).stack[4]
    triple = torch.stack([-DIVERSITY_AMP * z4, 0.0 * z4,
                          DIVERSITY_AMP * z4])
    rng = np.random.default_rng(1)
    five = torch.as_tensor(
        (rng.normal(size=(5, R, R)) * 0.8).astype(np.float32), device=dev)
    total = (phase[:, None] + triple).reshape(-1, R, R)
    return (
        ("B1", "psf_div3_sym", (phase, pupil, cos_a, sin_a, op, scale),
         BF16_ATOL),
        ("B2 (3 maps)", "psf_div",
         (phase, pupil, torch.cos(triple), torch.sin(triple), op, scale),
         BF16_ATOL),
        ("B2 (5 random maps)", "psf_div",
         (phase, pupil, torch.cos(five), torch.sin(five), op, scale),
         BF16_ATOL_RANDOM_MAPS),
        ("B3 (total phases)", "psf_crop", (total, pupil, op, scale),
         BF16_ATOL),
        ("B4", "psf_div3_sym_thin", (phase, pupil, cos_a, sin_a, op, scale),
         BF16_ATOL),
    )


def bf16_check(label: str, name: str, wrapper, plain, args, want32,
               atol: float, R: int, B: int):
    """Max abs error of a bf16 entry against its plain version's bf16
    branch, beside that branch's gap from the float32 plain version
    ``want32``, and the bf16 plain output; fails above ``atol`` of the
    peak or 1/4 of the gap."""
    got = wrapper(*args, compute_dtype=BF16)
    torch.cuda.synchronize()
    want = plain(*args, compute_dtype=BF16)
    w = want.shape[-1]
    if got.shape != want.shape or not torch.isfinite(got).all():
        fail(f"{name} output at R={R} B={B} w={w}: shape "
             f"{tuple(got.shape)}, or not finite")
    peak = float(want.abs().max())
    err = float((got - want).abs().max())
    gap = float((want - want32).abs().max())
    print(f"kernel {label} bf16 ({name}) vs bf16 plain, R={R} B={B} w={w}: "
          f"max_abs_err {err:.3e} = {err / peak:.2e} of the peak {peak:.4g};"
          f" bf16 plain vs float32 plain {gap:.3e} = {gap / peak:.2e}; "
          f"tolerance {atol:g} of the peak and 1/4 of that gap")
    if not (err <= atol * peak and err <= gap / 4):
        fail(f"{name} disagrees with its bf16 plain version at R={R} B={B} "
             f"w={w}")
    return err, want


def misrounded_b1_check(b1: torch.Tensor, fields_rounded: torch.Tensor,
                        R: int, B: int) -> None:
    """How far a B1 bf16 kernel that rounded its +- fields, instead of
    its four products, would miss B1's bf16 plain output ``b1``: that is
    B2's bf16 plain output on the triple, ``fields_rounded``.  Fails at
    the main path's R=128 if BF16_ATOL would not catch it."""
    peak = float(b1.abs().max())
    miss = float((fields_rounded - b1).abs().max()) / peak
    print(f"kernel B1 bf16 rounding its +- fields (B2's bf16 plain version "
          f"on the triple) vs B1's bf16 plain, R={R} B={B}: {miss:.2e} of "
          f"the peak; B1's limit {BF16_ATOL:g}")
    if R == 128 and not miss > BF16_ATOL:
        fail(f"B1's bf16 limit {BF16_ATOL:g} would not catch a kernel "
             f"rounding its +- fields ({miss:.2e} of the peak)")


def float32_check(label: str, lib: str, wrapper, plain, args, R: int,
                  B: int):
    """Max abs error of a float32 kernel against its plain version, and
    the plain output; fails beyond rtol 2e-4 and atol 1e-5 of the peak,
    and for B1 at a 31-px crop beyond B1_F32_ATOL of the peak."""
    got = wrapper(*args)
    torch.cuda.synchronize()
    want = plain(*args)
    w = want.shape[-1]
    if got.shape != want.shape or not torch.isfinite(got).all():
        fail(f"{label} output at R={R} B={B} w={w}: shape "
             f"{tuple(got.shape)}, or not finite")
    err = (got - want).abs()
    peak = float(want.abs().max())
    atol = 1e-5 * peak
    rel = float((err / want.abs().clamp_min(atol)).max())
    limit = (B1_F32_ATOL[128 if R <= 128 else 512]
             if lib == "psf_div3_sym" and w == 2 * CROP_HALF + 1 else None)
    print(f"kernel {label} vs plain, R={R} B={B} w={w}: max_abs_err "
          f"{float(err.max()):.3e} = {float(err.max()) / peak:.2e} of the "
          f"peak {peak:.4g}, max rel err {rel:.3e}; tolerance rtol 2e-4, "
          f"atol {atol:.3e}" + (f", {limit:g} of the peak" if limit else ""))
    if not bool((err <= 2e-4 * want.abs() + atol).all()):
        fail(f"{label} disagrees with its plain version at R={R} B={B} "
             f"w={w}")
    if limit and not float(err.max()) <= limit * peak:
        fail(f"{label} errs {float(err.max()) / peak:.2e} of the peak at "
             f"R={R} B={B}, beyond the mma.sync design's {limit:g}")
    return float(err.max()), want


def kernel_phase(dev) -> dict:
    """Max abs error of each kernel against its plain version, and of
    each bf16 entry against its plain version's bf16 branch, at every
    (R, B, crop width) of KERNEL_SHAPES; B1 float32 also at
    B1_F32_SHAPES."""
    funcs = {k[0]: (k[1], k[2]) for k in KERNELS}
    max_err = {k[0]: 0.0 for k in KERNELS}
    bf16_of = {lib: name for name, lib, *_ in BF16_KERNELS}
    max_err.update({name: 0.0 for name in bf16_of.values()})
    for R, B, crop_half in KERNEL_SHAPES:
        bf16_plain = {}
        for label, lib, args, bf16_atol in kernel_cases(R, B, dev, crop_half):
            wrapper, plain = funcs[lib]
            err, want = float32_check(label, lib, wrapper, plain, args, R, B)
            max_err[lib] = max(max_err[lib], err)
            name = bf16_of[lib]
            err, bf16_plain[label] = bf16_check(
                label, name, wrapper, plain, args, want, bf16_atol, R, B)
            max_err[name] = max(max_err[name], err)
        if crop_half == CROP_HALF:
            misrounded_b1_check(bf16_plain["B1"], bf16_plain["B2 (3 maps)"],
                                R, B)
    R, B = RAGGED_BF16
    for label, lib, args, bf16_atol in kernel_cases(R, B, dev):
        name = bf16_of[lib]
        if name not in WGMMA_ENTRIES:
            continue
        wrapper, plain = funcs[lib]
        err, _ = bf16_check(label, name, wrapper, plain, args, plain(*args),
                            bf16_atol, R, B)
        max_err[name] = max(max_err[name], err)
    wrapper, plain = funcs["psf_div3_sym"]
    for R, B in B1_F32_SHAPES:
        err, _ = float32_check("B1", "psf_div3_sym", wrapper, plain,
                               b1_args(R, B, dev), R, B)
        max_err["psf_div3_sym"] = max(max_err["psf_div3_sym"], err)
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


def check_shares(label: str, shares: dict) -> None:
    """Fails if any share (in %) of a ceiling exceeds 105%: it can only
    mean a wrong work count or timing."""
    for key, pct in shares.items():
        if pct > 100 * MAX_SHARE:
            fail(f"{label}: {key} = {pct:.1f}%")


def fp32_share(bound: dict, ms: float, label: str = "FP32 bound") -> str:
    """'; <label> t ms, p%' for a float32 kernel's measure_bound; '' for
    a bf16 one's, which has no FP32 bound."""
    b = bound["fp32_bound_ms"]
    return "" if b is None else f"; {label} {b:.4f} ms, {100 * b / ms:.1f}%"


def variants_phase(card: str) -> tuple[dict, dict]:
    """The A/B entry point in turns kernels, plain, kernels; returns the
    main shape's times per variant and the launches of its first run.
    Then the kernels alone at R=128, B=4096 with the WIDE_CROPS, where
    every kernel must launch too."""
    times = {}
    for R, B in SHAPES:
        reset_launches()
        k1 = kernel_variants.run(R, B)
        if (R, B) == (128, BATCH):
            launches = {k[0]: k[1].launches for k in KERNELS}
            launches.update({name: wrapper.launches_bf16
                             for name, _, wrapper, *_ in BF16_KERNELS})
        plain = kernel_variants.run(R, B, plain=True, reps=5)
        k2 = kernel_variants.run(R, B)
        for run_ in (k1, plain, k2):
            print("variants: " + json.dumps(run_))
        for v in kernel_variants.VARIANTS + kernel_variants.BF16_VARIANTS:
            k_ms, p_ms = min(k1[v + "_ms"], k2[v + "_ms"]), plain[v + "_ms"]
            base, dtype = kernel_variants.precision(v)
            b = roofline.measure_bound(base, R, B, compute_dtype=dtype)
            print(f"variant {v} R={R} B={B}: kernel {k1[v + '_ms']:.4f} / "
                  f"{k2[v + '_ms']:.4f} ms, plain {p_ms:.4f} ms per call, "
                  f"bound {b['bound_ms']:.4f} ms ({b['limit']}: tensor "
                  f"{b['tensor_ms']:.4f}, fp32 {b['fp32_ms']:.4f}, bytes "
                  f"{b['bytes_ms']:.4f}), {100 * b['bound_ms'] / k_ms:.1f}% "
                  f"of bound{fp32_share(b, k_ms)} [{card}]")
            if (R, B) == (128, BATCH):
                times[v] = (k_ms, p_ms)
    for lib, n in launches.items():
        if n < 1:
            fail(f"the kernel A/B launched {lib} {n} times")
    for w in WIDE_CROPS:
        reset_launches()
        run_ = kernel_variants.run(128, BATCH, w=w)
        print("variants: " + json.dumps(run_))
        wide = {}
        for name, lib, wrapper, *_ in BF16_KERNELS:
            wide.update({lib: wrapper.launches, name: wrapper.launches_bf16})
        print(f"variants w={w}: launches {json.dumps(wide)}")
        for entry, n in wide.items():
            if n < 1:
                fail(f"the kernel A/B at w={w} launched {entry} {n} times")
        for v in kernel_variants.VARIANTS + kernel_variants.BF16_VARIANTS:
            k_ms = run_[v + "_ms"]
            base, dtype = kernel_variants.precision(v)
            b = roofline.measure_bound(base, 128, BATCH, w=w,
                                       compute_dtype=dtype)
            share = 100 * b["bound_ms"] / k_ms
            print(f"variant {v} R=128 B={BATCH} w={w}: kernel {k_ms:.4f} ms "
                  f"per call, bound {b['bound_ms']:.4f} ms ({b['limit']}), "
                  f"{share:.1f}% of bound{fp32_share(b, k_ms)} [{card}]")
            check_shares(f"variant {v} w={w}", {"share of the bound": share})
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


def slice_cfg(dft_dtype: str = "float32", crop_half: int = CROP_HALF):
    cfg = roofline.bench_cfg(128)
    return cfg.replace(estimator=dataclasses.replace(
        cfg.estimator, gauss_newton_iters=0, dft_dtype=dft_dtype,
        crop_half=crop_half))


def on_route(loop, route: str):
    return dataclasses.replace(loop, est=estimator.with_route(loop.est,
                                                              route))


def run_loop(sys_, cfg, scen, n_steps, init_u=None):
    """The shared-window loop over ``scen`` for n_steps, synchronized."""
    out = montecarlo.run_batch(sys_.loop, sys_.layers, cfg, scen, n_steps,
                               shared_window="verified", init_u=init_u)
    torch.cuda.synchronize()
    return out


def slice_phase(system, system_bf16, cfg, dev,
                card) -> tuple[dict, dict, dict]:
    """Launches of each run's kernel in its 25-step loop -- the float32
    build through B1, B2 and B3, then the bf16 build (dft_dtype
    "bfloat16") through their bf16 entries -- each run's best seconds,
    keyed by route (bf16 runs: "<route> bf16"), and the float32 B1 run's
    settled numbers (``settled``): the fixed Newton step's, which the
    solvers phase compares its runs with."""
    scen = montecarlo.make_scenarios(cfg, torch.Generator().manual_seed(1),
                                     BATCH, device=dev)
    montecarlo.assert_shared_window(scen)
    # (label, launch count name, wrapper, route, system, bf16)
    runs = [(route, lib, wrapper, route, system, False)
            for lib, wrapper, *_, route in KERNELS if route]
    runs += [(f"{route} bf16", name, wrapper, route, system_bf16, True)
             for name, _, wrapper, *_, route in BF16_KERNELS if route]

    def run(route, sys_):
        out = montecarlo.run_batch(on_route(sys_.loop, route), sys_.layers,
                                   cfg, scen, STEPS,
                                   shared_window="verified")
        torch.cuda.synchronize()
        return out
    launches = {}
    strehl_b1 = None
    for label, name, wrapper, route, sys_, bf16 in runs:
        reset_launches()
        out = run(route, sys_)
        launches[name] = wrapper.launches_bf16 if bf16 else wrapper.launches
        if launches[name] < STEPS:
            fail(f"the {label} loop launched {name} {launches[name]} times "
                 f"in {STEPS} steps")
        if bf16 and wrapper.launches:
            fail(f"the {label} loop launched the float32 kernel "
                 f"{wrapper.launches} times")
        strehl = loop_checks(
            f"slice ({label}, {name}): R={cfg.resolution} B={BATCH} "
            f"steps={STEPS}: {name} launches {launches[name]}", out,
            sys_.loop.influence.shape[1], BATCH)
        if strehl_b1 is None:
            strehl_b1, fixed = strehl, settled(out)
        elif abs(strehl - strehl_b1) > ROUTE_STREHL_TOL:
            fail(f"{label}: settled exact Strehl {strehl:.5f} is not within "
                 f"{ROUTE_STREHL_TOL} of the float32 B1 loop's "
                 f"{strehl_b1:.5f}")
        reference_phase(on_route(sys_.loop, route), sys_.layers, cfg, dev,
                        label)
    # run times, the runs in turns: forward, backward, forward
    times = {label: [] for label, *_ in runs}
    for label, _, _, route, sys_, _ in runs + runs[::-1] + runs:
        t0 = time.perf_counter()
        run(route, sys_)
        times[label].append(time.perf_counter() - t0)
    for label, ts in times.items():
        print(f"slice ({label}) run: {min(ts):.4f} s (best of {ts}), "
              f"{BATCH * STEPS / min(ts):.1f} solves/s [{card}]")
    return launches, {label: min(ts) for label, ts in times.items()}, fixed


def loop_checks(label: str, out, nu: int, B: int,
                min_strehl: float = MIN_STREHL) -> float:
    """Fails on a run whose u is not (B, STEPS, nu), whose outputs are
    not finite, or whose settled exact Strehl is below ``min_strehl``;
    prints and returns that Strehl."""
    if out.u.shape != (B, STEPS, nu):
        fail(f"{label}: u has shape {tuple(out.u.shape)}")
    for field_name, field in zip(out._fields, out):
        if not bool(torch.isfinite(field).all()):
            fail(f"{label}: non-finite {field_name}")
    settle = STEPS // 2
    strehl = float(out.strehl_exact[:, settle:].mean())
    print(f"{label}: settled exact Strehl {strehl:.5f}, Marechal "
          f"{float(out.strehl[:, settle:].mean()):.5f}, residual RMS "
          f"{float(out.rms_res[:, settle:].mean()):.5f} rad")
    if strehl < min_strehl:
        fail(f"{label}: settled exact Strehl {strehl:.5f} < {min_strehl}")
    return strehl


def wide_phase(system, system_wide, cfg, cfg_wide, dev, card) -> None:
    """The bench configuration with estimator.crop_half=WIDE_CROP_HALF
    (41-px crops, two crop bands) through B1: 25 steps at B=4096 must
    launch B1 once a step and settle at exact Strehl >= MIN_STREHL; the
    B=4 loop on the card and on the CPU agree; then its run time beside
    the 31-px run's, in turns."""
    w = 2 * system_wide.est.crop_half + 1
    scen = montecarlo.make_scenarios(cfg, torch.Generator().manual_seed(1),
                                     BATCH, device=dev)
    b1 = K.psf_crop_diversity_sym3
    reset_launches()
    out = run_loop(system_wide, cfg_wide, scen, STEPS)
    if b1.launches != STEPS:
        fail(f"the {w}-px loop launched psf_div3_sym {b1.launches} times in "
             f"{STEPS} steps")
    nu = system_wide.loop.influence.shape[1]
    loop_checks(f"wide ({w}-px crops, psf_div3_sym launches {b1.launches}):"
                f" R={cfg_wide.resolution} B={BATCH} steps={STEPS}", out, nu,
                BATCH)
    reference_phase(system_wide.loop, system_wide.layers, cfg_wide, dev,
                    f"sym3, {w}-px crops")
    times = {31: [], w: []}
    for _ in range(3):
        for width, sys_, c in ((31, system, cfg), (w, system_wide, cfg_wide)):
            t0 = time.perf_counter()
            run_loop(sys_, c, scen, STEPS)
            times[width].append(time.perf_counter() - t0)
    for width, ts in times.items():
        print(f"wide: {width}-px crops, B1 route: {min(ts):.4f} s (best of "
              f"{ts}), {BATCH * STEPS / min(ts):.1f} solves/s [{card}]")


def loop_512_phase(dev, card) -> None:
    """ROADMAP C.3: the bench configuration at R=512, B=256 (its own
    build, as the roofline entry point's), 25 steps through B1 and B2:
    each keeps lock (settled exact Strehl >= LOCK_STREHL; the bench's
    0.975 is set at R=128), and the two settle within ROUTE_STREHL_TOL of
    each other; the B=4 loop through B1 on the card and on the CPU
    agree."""
    R, B = LOOP_512
    cfg = roofline.bench_cfg(R)
    cfg = cfg.replace(estimator=dataclasses.replace(cfg.estimator,
                                                    gauss_newton_iters=0))
    t0 = time.time()
    system = pipeline.build(cfg, dev)
    torch.cuda.synchronize()
    print(f"loop R={R}: pipeline.build in {time.time() - t0:.2f} s")
    scen = montecarlo.make_scenarios(cfg, torch.Generator().manual_seed(1),
                                     B, device=dev)
    strehl = {}
    for route, lib, wrapper in (("sym3", "psf_div3_sym",
                                 K.psf_crop_diversity_sym3),
                                ("general", "psf_div", K.psf_crop_diversity)):
        reset_launches()
        t0 = time.perf_counter()
        out = montecarlo.run_batch(on_route(system.loop, route),
                                   system.layers, cfg, scen, STEPS,
                                   shared_window="verified")
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        if wrapper.launches < STEPS:
            fail(f"the R={R} {route} loop launched {lib} {wrapper.launches} "
                 f"times")
        strehl[route] = loop_checks(
            f"loop R={R} B={B} ({route}, {lib} launches {wrapper.launches}, "
            f"{secs:.4f} s) [{card}]", out, system.loop.influence.shape[1],
            B, LOCK_STREHL)
    reference_phase(system.loop, system.layers, cfg, dev, f"sym3, R={R}")
    diff = abs(strehl["sym3"] - strehl["general"])
    print(f"loop R={R}: B1 vs B2 settled exact Strehl differ by {diff:.2e}; "
          f"tolerance {ROUTE_STREHL_TOL}")
    if diff > ROUTE_STREHL_TOL:
        fail(f"the R={R} loops through B1 and B2 differ by {diff:.5f} in "
             "settled exact Strehl")


def roofline_phase(system, cfg, peaks: dict, times: dict, card: str):
    """Roofline rows on the slice's build, against the published and the
    measured peaks; B1-B4 and the bf16 variants against their bound at the
    measured ceilings, the float32 ones beside the measured-FP32 bound
    (every FLOP on FP32)."""
    rows = [roofline.measure_row(R, B, peaks) for R, B in SHAPES]
    rows += [roofline.step_row(system, cfg, BATCH, gn, peaks)
             for gn in (0, 1)]
    rows.append(roofline.solve_row(system, peaks=peaks))
    for r in rows:
        tensor = (f"DFT stages {r['pct_published_tf32']:.2f}% of published "
                  f"TF32, {r['pct_measured_tf32']:.2f}% of measured; "
                  if "pct_measured_tf32" in r else "")
        print(f"roofline {r['label']}: {r['wall_us_per_iter']:.2f} us per "
              f"iteration; {r['achieved_tflops']:.3f} TFLOP/s; {tensor}"
              f"other FLOPs {r['pct_published_fp32']:.2f}% of published "
              f"FP32, {r['pct_measured_fp32']:.2f}% of measured; "
              f"{r['achieved_gbps']:.1f} GB/s = {r['pct_published_hbm']:.2f}% "
              f"of published HBM, {r['pct_measured_hbm']:.2f}% of measured; "
              f"{r['achieved_gtransc_per_s']:.2f} G transcendentals/s = "
              f"{r['pct_measured_transc']:.2f}% of measured; bound "
              f"{r['bound']} [{card}]")
        check_shares(f"roofline {r['label']}",
                     {k: v for k, v in r.items() if k.startswith("pct_")
                      and k != "pct_of_binding_peak"})
    for v, (k_ms, _) in times.items():
        base, dtype = kernel_variants.precision(v)
        pub = roofline.measure_bound(base, 128, BATCH, compute_dtype=dtype)
        meas = roofline.measure_bound(base, 128, BATCH, peaks=peaks,
                                      compute_dtype=dtype)
        print(f"variant {v} R=128 B={BATCH}: {k_ms:.4f} ms; "
              f"{100 * pub['bound_ms'] / k_ms:.1f}% of the bound "
              f"{pub['bound_ms']:.4f} ms at the published peaks, "
              f"{100 * meas['bound_ms'] / k_ms:.1f}% of the bound "
              f"{meas['bound_ms']:.4f} ms ({meas['limit']}) at the measured "
              f"ones{fp32_share(meas, k_ms, 'measured-FP32 bound')} [{card}]")
        check_shares(f"variant {v}", {
            "share of the bound at the published peaks":
                100 * pub["bound_ms"] / k_ms,
            "share of the bound at the measured ceilings":
                100 * meas["bound_ms"] / k_ms})


def trace_phase(system, cfg, untraced_s: float, card: str) -> None:
    """One torch.profiler trace of the 25-step B1 run (trace_run)."""
    scen = montecarlo.make_scenarios(cfg, torch.Generator().manual_seed(1),
                                     BATCH, device="cuda")
    trace_run(f"{STEPS}-step B1 run, B={BATCH}", lambda: montecarlo.run_batch(
        system.loop, system.layers, cfg, scen, STEPS,
        shared_window="verified"), untraced_s, card, TRACE_DIR)


def trace_run(label: str, run, untraced_s: float, card: str,
              trace_dir: Path,
              shares: dict | None = None) -> tuple[dict, float | None]:
    """One torch.profiler trace of ``run()``: device busy time against
    the traced run's own wall time (and, beside it, against the untraced
    run timed before), and the top kernels and ops by device time; with
    ``shares`` ({label: kernel-name regex}) each group's share of busy.
    Prints and returns the seconds the trace took, by part (the traced
    run, the profiler's stop and Chrome-trace export, key_averages()),
    and B1's share of the busy time in % (None without device time)."""
    t_start = time.perf_counter()
    with profiling.trace(str(trace_dir)) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        traced_s = time.perf_counter() - t0
    t_stop = time.perf_counter()
    avg = prof.key_averages()
    secs = {"trace_start": t0 - t_start, "trace_run": traced_s,
            "trace_stop_export": t_stop - t0 - traced_s,
            "trace_key_averages": time.perf_counter() - t_stop}
    mib = (trace_dir / "trace.json").stat().st_size / 2 ** 20
    print(f"trace timing: {label}: profiler start "
          f"{secs['trace_start']:.2f} s, traced run {traced_s:.2f} s, stop "
          f"and export {secs['trace_stop_export']:.2f} s ({mib:.1f} MiB "
          f"trace.json), key_averages {secs['trace_key_averages']:.2f} s")
    launches = sum(e.count for e in avg if e.key == "cudaLaunchKernel")
    print(f"trace host: {label}: {launches} kernel launches, host self CPU "
          f"{sum(e.self_cpu_time_total for e in avg) / 1e3:.3f} ms in the "
          f"traced run")
    kernels = sorted((e for e in avg if e.device_type == DeviceType.CUDA),
                     key=lambda e: -e.self_device_time_total)
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    if busy_ms == 0:
        print("trace: key_averages() shows no device time; the CUDA-event "
              "and host-clock times above stand")
        return secs, None
    print(f"trace: {label}: device busy {busy_ms:.3f}"
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
    for group, pattern in (shares or {}).items():
        ms = sum(e.self_device_time_total for e in kernels
                 if re.search(pattern, e.key)) / 1e3
        calls = sum(e.count for e in kernels if re.search(pattern, e.key))
        print(f"trace share: {label}: {group}: {ms:.3f} ms "
              f"({100 * ms / busy_ms:.1f}% of busy), {calls} calls [{card}]")
    b1_ms = sum(e.self_device_time_total for e in kernels
                if re.search(r"\bpsf_div3_sym_kernel\b", e.key)) / 1e3
    return secs, 100 * b1_ms / busy_ms


def reference_phase(loop, layers, cfg, dev, route: str, n_steps: int = STEPS,
                    mag=None, init_u=None, edge=None) -> tuple[float, float]:
    """The loop at B=4 on the card (kernel) and on the CPU (plain
    version), same operators, injected noise, magnifications (default
    1.0-1.8) and warm-start command; with ``edge`` (an edge-flow model
    and state) on the conditional flow, one realization shared by the 4
    scenarios, with the same injected border normals.  Returns the
    seconds of the card's run and of the CPU's."""
    t0 = time.perf_counter()
    B = 4
    rng = np.random.default_rng(5)
    noise = torch.as_tensor(
        (float(loop.est.noise_std) * rng.standard_normal(
            (B, n_steps, loop.est.n_pixels))).astype(np.float32))
    mag = torch.linspace(1.0, 1.8, B) if mag is None else mag
    kw = dict(n_steps=n_steps, start_step=cfg.sim.n_train + cfg.sim.n_valid,
              mag=mag)
    gpu_edge, cpu_edge = {}, {}
    if edge is not None:
        model, state = edge
        eps = torch.as_tensor(rng.standard_normal(
            (n_steps, model.k_max + 1, model.n_layers, model.n_border)
        ).astype(np.float32))
        gpu_edge = dict(edge_model=model, edge_state=state,
                        edge_eps=eps.to(dev))
        cpu_edge = dict(edge_model=tree.cast(model, device="cpu"),
                        edge_state=tree.cast(state, device="cpu"),
                        edge_eps=eps)
    gpu = closed_loop.simulate(loop, layers, cfg, None,
                               noise_seq=noise.to(dev), init_u=init_u,
                               **gpu_edge, **kw)
    torch.cuda.synchronize()
    t_cpu = time.perf_counter()
    cpu = closed_loop.simulate(
        tree.cast(loop, device="cpu"),
        None if layers is None else tree.cast(layers, device="cpu"), cfg,
        None, noise_seq=noise,
        init_u=None if init_u is None else init_u.cpu(), **cpu_edge, **kw)
    cpu_s = time.perf_counter() - t_cpu
    u_ref, rms_ref = cpu.u.numpy(), cpu.rms_res.numpy()
    u, rms = gpu.u.cpu().numpy(), gpu.rms_res.cpu().numpy()
    u_err = float(np.abs(u - u_ref).max() / np.abs(u_ref).max())
    rms_err = float(np.max(np.abs(rms - rms_ref) / rms_ref))
    print(f"reference ({route}): B={B} {n_steps}-step loop on the card vs on "
          f"the CPU: u max err {u_err:.3e} of max|u| (tolerance 0.02), "
          f"residual RMS max rel err {rms_err:.3e} (tolerance 0.01); "
          f"card {t_cpu - t0:.2f} s, CPU {cpu_s:.2f} s")
    if not np.allclose(rms, rms_ref, rtol=0.01, atol=5e-3) or u_err > 0.02:
        fail(f"{route}: the loop on the card disagrees with the CPU loop")
    return t_cpu - t0, cpu_s


def recipe_cfg(R: int, d_over_r0: float, n_steps: int):
    """reference_config(R) with the strong-turbulence recipe
    (config.strong_turbulence) and the sim defaults (n_train 1000,
    n_valid 500)."""
    cfg = strong_turbulence(reference_config(resolution=R), d_over_r0)
    return cfg.replace(sim=dataclasses.replace(cfg.sim, n_test=n_steps))


def build_timed(label: str, cfg, dev):
    t0 = time.time()
    system = pipeline.build(cfg, dev)
    torch.cuda.synchronize()
    secs = time.time() - t0
    print(f"{label}: pipeline.build at R={cfg.resolution} in {secs:.2f} s")
    return system, secs


def strong_phase(dev, card) -> dict:
    """ROADMAP A.7: the strong-turbulence recipe at published width
    (MONTECARLO512_r05.json's D/r0=10 block) through B1, traced once; the
    B=4 card-vs-CPU check; then the tracking estimator and the
    estimator-VAR fusion at R=128.  Prints where the phase's seconds go
    and returns B1's launches per run."""
    t_phase = time.time()
    secs = {}
    b1 = K.psf_crop_diversity_sym3
    R, d, n = STRONG_R, STRONG_D, STRONG_STEPS
    cfg = recipe_cfg(R, d, n)
    system, secs["build"] = build_timed(f"strong R={R} D/r0={d:g}", cfg, dev)
    start = cfg.sim.n_train + cfg.sim.n_valid
    t0 = time.perf_counter()
    init_u = pipeline.warm_start_command(system, cfg, start)
    secs["warm_start"] = time.perf_counter() - t0
    reps = STRONG_REPS
    B = reps * len(STRONG_SNRS)
    scales = np.repeat([10.0 ** ((cfg.estimator.snr_db - s) / 20.0)
                        for s in STRONG_SNRS], reps)
    f32 = dict(dtype=torch.float32, device=dev)
    scen = montecarlo.ScenarioBatch(
        start_step=torch.full((B,), float(start), **f32),
        mag=torch.full((B,), cfg.sim.magnification, **f32),
        noise_scale=torch.as_tensor(scales, **f32), noise_seed=int(d))

    reset_launches()
    t0 = time.perf_counter()
    out = run_loop(system, cfg, scen, n, init_u)
    secs["first_run"] = first_s = time.perf_counter() - t0
    launches = {"strong": b1.launches}
    t0 = time.perf_counter()
    run_loop(system, cfg, scen, n, init_u)
    secs["warm_run"] = run_s = time.perf_counter() - t0
    print(f"strong R={R} D/r0={d:g} B={B} steps={n}: build "
          f"{secs['build']:.2f} s, run {run_s:.4f} s ({B * n / run_s:.1f} "
          f"solves/s; the first run, warm-up included, {first_s:.4f} s), "
          f"psf_div3_sym launches {launches['strong']} in the first run "
          f"[{card}]")
    if launches["strong"] < 2 * n:
        fail(f"the strong-turbulence run launched psf_div3_sym "
             f"{launches['strong']} times in {n} steps, fewer than 2 a step")
    t0 = time.perf_counter()
    settle = n // 2
    res = out.rms_res[:, settle:].cpu().numpy()
    turb = out.rms_turb[:, settle:].cpu().numpy()
    sx = out.strehl_exact[:, settle:].cpu().numpy()
    for i, snr in enumerate(STRONG_SNRS):
        sl = slice(i * reps, (i + 1) * reps)
        rm = res[sl].mean(axis=1)
        ok = np.isfinite(rm) & (rm <= 10.0 * turb[sl].mean(axis=1))
        per = sx[sl][ok].mean(axis=1)
        mean = float(per.mean()) if ok.any() else float("nan")
        p10 = float(np.percentile(per, 10)) if ok.any() else float("nan")
        print(f"strong R={R} D/r0={d:g} SNR {snr:g} dB: settled exact "
              f"Strehl {mean:.5f} (p10 {p10:.5f}) over {reps} scenarios, "
              f"{int((~ok).sum())} diverged; JAX target {JAX_STRONG[0]}-"
              f"{JAX_STRONG[1]}, gap {mean - JAX_STRONG[0]:+.5f} to its low "
              f"end")
        if not ok.all() or not mean >= STRONG_MIN_STREHL:
            fail(f"strong SNR {snr:g} dB: settled exact Strehl {mean:.5f} "
                 f"(floor {STRONG_MIN_STREHL}), {int((~ok).sum())} diverged")
    secs["quality"] = time.perf_counter() - t0

    def window():
        return run_loop(system, cfg, scen, STRONG_TRACE_STEPS, init_u)
    t0 = time.perf_counter()
    window()
    secs["window_run"] = window_s = time.perf_counter() - t0
    trace_secs, b1_share = trace_run(
        f"{STRONG_TRACE_STEPS}-step window of the strong-turbulence run, "
        f"R={R}, B={B}", window, window_s, card, TRACE_DIR / "strong")
    secs.update(trace_secs)
    if b1_share is not None:
        print(f"strong: B1 (psf_div3_sym_kernel) {b1_share:.1f}% of device "
              f"busy in the {STRONG_TRACE_STEPS}-step window; "
              f"{B1_SHARE_500:.1f}% in the 500-step trace (PERF.md §5)")
    secs["reference_card"], secs["reference_cpu"] = reference_phase(
        system.loop, system.layers, cfg, dev, f"strong, R={R}, D/r0={d:g}",
        mag=torch.full((4,), cfg.sim.magnification), init_u=init_u)
    del system, out

    R, d, B, n = TRACK
    cfg = recipe_cfg(R, d, n)
    cfg = cfg.replace(
        estimator=dataclasses.replace(cfg.estimator, track_gn_iters=1),
        mpc=dataclasses.replace(cfg.mpc, est_gain=0.9, innovation_gate=5.0))
    system, secs["tracking_build"] = build_timed(
        f"tracking R={R} D/r0={d:g}", cfg, dev)
    init_u = pipeline.warm_start_command(system, cfg, start)
    scen = montecarlo.make_scenarios(
        cfg, torch.Generator().manual_seed(1), B, d_over_r0_grid=(d,),
        snr_db_grid=STRONG_SNRS, device=dev)

    def track():
        return run_loop(system, cfg, scen, n, init_u)
    reset_launches()
    t0 = time.perf_counter()
    out = track()
    secs["tracking_first_run"] = time.perf_counter() - t0
    launches["tracking"] = b1.launches
    warm = []
    for _ in range(TRACK_TIMED):
        t0 = time.perf_counter()
        track()
        warm.append(time.perf_counter() - t0)
    secs["tracking_warm_runs"] = sum(warm)
    step_ms = sorted(1e3 * t / n for t in warm)
    for field_name, field in zip(out._fields, out):
        if not bool(torch.isfinite(field).all()):
            fail(f"the tracking run gave a non-finite {field_name}")
    print(f"tracking R={R} D/r0={d:g} B={B} steps={n} (track_gn_iters 1, "
          f"est_gain 0.9, innovation_gate 5): settled exact Strehl "
          f"{float(out.strehl_exact[:, n // 2:].mean()):.5f}, residual RMS "
          f"{float(out.rms_res[:, n // 2:].mean()):.5f} rad; warm runs "
          f"{step_ms[len(step_ms) // 2]:.3f} ms a step (median of "
          f"{TRACK_TIMED}, {step_ms[0]:.3f}-{step_ms[-1]:.3f}; the first "
          f"run, warm-up included, "
          f"{1e3 * secs['tracking_first_run'] / n:.3f}), psf_div3_sym "
          f"launches {launches['tracking']} in the first run [{card}]")
    if launches["tracking"] < 4 * n:
        fail(f"the tracking run launched psf_div3_sym {launches['tracking']}"
             f" times in {n} steps, fewer than 4 a step")
    secs["tracking_reference_card"], secs["tracking_reference_cpu"] = (
        reference_phase(system.loop, system.layers, cfg, dev,
                        f"tracking, R={R}, D/r0={d:g}", n_steps=10,
                        mag=torch.full((4,), cfg.sim.magnification),
                        init_u=init_u))
    total = time.time() - t_phase
    print(f"strong: phase in {total:.2f} s: " + ", ".join(
        f"{k} {v:.2f}" for k, v in secs.items())
        + f", other {total - sum(secs.values()):.2f} s")
    return launches


def edge_cfg():
    """reference_config(EDGE_R) on the conditional flow, with the JAX
    protocol's n_train 1000 and n_valid 50."""
    cfg = reference_config(resolution=EDGE_R)
    return cfg.replace(
        atmosphere=dataclasses.replace(cfg.atmosphere, flow="conditional"),
        sim=dataclasses.replace(cfg.sim, n_train=1000, n_valid=50,
                                n_test=EDGE_STEPS))


@contextlib.contextmanager
def timed_calls(*sites):
    """Within the block, the seconds spent in each (module, name)
    function, the card synchronized around each call, in the dict it
    yields."""
    secs = {name: 0.0 for _, name in sites}

    def timing(name, fn):
        def call(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            secs[name] += time.perf_counter() - t0
            return out
        return call
    originals = [(module, name, getattr(module, name))
                 for module, name in sites]
    for module, name, fn in originals:
        setattr(module, name, timing(name, fn))
    try:
        yield secs
    finally:
        for module, name, fn in originals:
            setattr(module, name, fn)


def edge_stream(model, state, dev, card) -> None:
    """The conditional flow's operator stream on the card: K_max + 1
    border draws (one step's) from one (L, n, n) state, and whole
    advances from it, timed with CUDA events, against the floor of the
    A and Bc bytes a step streams over the published HBM rate."""
    K = model.k_max
    op_bytes = (model.A.numel() * model.A.element_size()
                + model.Bc.numel() * model.Bc.element_size())
    hbm = profiling.DEVICE_PEAKS["h100_sxm"]["hbm_bytes_per_s"]
    floor_ms = 1e3 * (K + 1) * op_bytes / hbm
    eps = torch.randn((K + 1, 1, model.n_layers, model.n_border), device=dev)
    phases = state.phases[None]

    def draws():
        for s in range(K + 1):
            edge_flow._draw_borders(model, phases, eps[s])
    draws_ms = profiling.cuda_time_ms(draws, 5)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def advances():
        st = state
        for i in range(EDGE_STREAM_STEPS):
            st, _ = edge_flow.advance(model, st, 1050 + i, gen)
    step_ms = profiling.cuda_time_ms(advances, 1) / EDGE_STREAM_STEPS
    gbs = (K + 1) * op_bytes / draws_ms / 1e6
    print(f"edge stream R={model.size}: {K + 1} border draws a step stream "
          f"{(K + 1) * op_bytes / 1e9:.3f} GB of A and Bc "
          f"({model.A.dtype}): {draws_ms:.4f} ms ({gbs:.1f} GB/s), floor "
          f"{floor_ms:.4f} ms at the published {hbm / 1e12:.2f} TB/s "
          f"({100 * floor_ms / draws_ms:.1f}% of it); a whole advance "
          f"{step_ms:.4f} ms a step (mean of {EDGE_STREAM_STEPS} steps "
          f"from step 1050) [{card}]")


def edge_phase(dev, card) -> dict:
    """ROADMAP A.9: the conditional-Gaussian flow at R=512 through B1, in
    the JAX protocol (benchmarks/protocol_edge.py:150-200): one build,
    timed by part; the reference rows from the build's state (shared
    turbulence over the D/r0 grid, 500 steps; D/r0=5 held), timed warm
    and traced over a 10-step window; the B=32 Monte-Carlo at D/r0=5;
    per-scenario turbulence from EDGE_REALIZATIONS batch_states start
    states at every D/r0 of the grid (the median held to
    EDGE_MIN_STREHL); the operator stream; the B=4 card-vs-CPU check
    with injected border normals.  B1 launches exactly
    1 + gauss_newton_iters times a step in every run (the measure and
    the Gauss-Newton pass).  Returns B1's launches per run."""
    t_phase = time.time()
    b1 = K.psf_crop_diversity_sym3
    cfg = edge_cfg()
    secs = {}
    with timed_calls((edge_flow, "extension_operators"),
                     (edge_flow, "_initial_phases"),
                     (edge_flow, "rollout")) as parts:
        system, secs["build"] = build_timed("edge", cfg, dev)
    model, state = system.edge_model, system.edge_state
    print(f"edge: build {secs['build']:.2f} s: extension operators "
          f"{parts['extension_operators']:.2f} s ({model.n_layers} layers, "
          f"nZ={model.A.shape[-1]}, nX={model.n_border}), initial screens "
          f"{parts['_initial_phases']:.2f} s, rollout of "
          f"{cfg.sim.n_train + cfg.sim.n_valid} steps "
          f"{parts['rollout']:.2f} s; nsub {model.nsub}, {model.k_max + 1} "
          f"draws a step [{card}]")
    start = cfg.sim.n_train + cfg.sim.n_valid
    nu = system.loop.influence.shape[1]
    f32 = dict(dtype=torch.float32, device=dev)
    B = len(EDGE_D_GRID)
    scen = montecarlo.ScenarioBatch(
        start_step=torch.full((B,), float(start), **f32),
        mag=torch.tensor([mag_conv(d) for d in EDGE_D_GRID], **f32),
        noise_scale=torch.ones((B,), **f32), noise_seed=1)

    def shared(sc, n):
        out = montecarlo.run_batch(system.loop, None, cfg, sc, n,
                                   edge_model=model, edge_state=state,
                                   shared_turbulence="verified")
        torch.cuda.synchronize()
        return out
    launches = {}

    # B1 measures once a step and once more a Gauss-Newton pass
    per_step = 1 + cfg.estimator.gauss_newton_iters

    def counted(label, run, n, batch):
        reset_launches()
        t0 = time.perf_counter()
        out = run()
        run_s = time.perf_counter() - t0
        launches[label] = b1.launches
        if b1.launches != per_step * n:
            fail(f"the edge {label} run launched psf_div3_sym {b1.launches}"
                 f" times in {n} steps, not {per_step} a step")
        for field_name, field in zip(out._fields, out):
            if not bool(torch.isfinite(field).all()):
                fail(f"the edge {label} run gave a non-finite {field_name}")
        if out.u.shape != (batch, n, nu):
            fail(f"the edge {label} run's u has shape {tuple(out.u.shape)}")
        return out, run_s

    n = EDGE_STEPS
    out, secs["rows_first_run"] = counted(
        "rows", lambda: shared(scen, n), n, B)
    t0 = time.perf_counter()
    shared(scen, n)
    secs["rows_warm_run"] = run_s = time.perf_counter() - t0
    print(f"edge rows R={EDGE_R} B={B} steps={n} (shared turbulence, from "
          f"the build's state): warm {run_s:.4f} s, "
          f"{1e3 * run_s / n:.3f} ms a step, {B * n / run_s:.1f} solves/s "
          f"(the first run, warm-up included, "
          f"{secs['rows_first_run']:.4f} s), psf_div3_sym launches "
          f"{launches['rows']} [{card}]")
    s0 = n // 2

    def row(label, out, i, d):
        res = out.rms_res[i, s0:].double()
        turb = out.rms_turb[i, s0:].double()
        strehl = float(out.strehl_exact[i, s0:].double().mean())
        print(f"{label} D/r0={d:g}: settled exact Strehl {strehl:.5f} (JAX "
              f"{JAX_EDGE[d]}), rejection "
              f"{float(turb.mean() / res.mean()):.3f}, residual RMS "
              f"{float(res.mean()):.5f} rad, turbulence "
              f"{float(turb.mean()):.5f} rad [{card}]")
        return strehl
    for i, d in enumerate(EDGE_D_GRID):
        strehl = row("edge row", out, i, d)
        if d == 5.0 and not strehl >= EDGE_MIN_STREHL[d]:
            fail(f"edge row D/r0={d:g}: settled exact Strehl {strehl:.5f} "
                 f"< {EDGE_MIN_STREHL[d]}")

    scen_mc = montecarlo.make_scenarios(
        cfg, torch.Generator().manual_seed(2), EDGE_MC_BATCH, device=dev)
    out, secs["mc_run"] = counted("mc", lambda: shared(scen_mc, n), n,
                                  EDGE_MC_BATCH)
    per = out.strehl_exact[:, s0:].double().mean(dim=1)
    mc = float(per.mean())
    print(f"edge Monte-Carlo R={EDGE_R} B={EDGE_MC_BATCH} D/r0=5 steps={n} "
          f"(shared turbulence): settled exact Strehl {mc:.5f} (min "
          f"{float(per.min()):.5f}; JAX 0.9848), {secs['mc_run']:.4f} s, "
          f"{1e3 * secs['mc_run'] / n:.3f} ms a step, "
          f"{EDGE_MC_BATCH * n / secs['mc_run']:.1f} solves/s, psf_div3_sym "
          f"launches {launches['mc']} [{card}]")
    if not mc >= EDGE_MC_MIN_STREHL:
        fail(f"edge Monte-Carlo: settled exact Strehl {mc:.5f} < "
             f"{EDGE_MC_MIN_STREHL}")

    # per-scenario turbulence: EDGE_REALIZATIONS start states, each at
    # every D/r0 of the grid (scenario i * len(grid) + j: state i, D/r0 j)
    S = EDGE_REALIZATIONS
    tel = dataclasses.replace(cfg.telescope, resolution=EDGE_R)
    t0 = time.perf_counter()
    states = edge_flow.batch_states(int(cfg.sim.seed) + 1, cfg.atmosphere,
                                    tel, S, device=dev)
    secs["batch_states"] = time.perf_counter() - t0
    scen_ps = montecarlo.ScenarioBatch(
        start_step=torch.full((S * B,), float(start), **f32),
        mag=scen.mag.repeat(S), noise_scale=torch.ones((S * B,), **f32),
        noise_seed=3)
    grid_states = edge_flow.EdgeFlowState(
        phases=states.phases.repeat_interleave(B, dim=0))
    out, secs["per_scenario_run"] = counted(
        "per-scenario", lambda: montecarlo.run_batch(
            system.loop, None, cfg, scen_ps, n, edge_model=model,
            edge_state=grid_states), n, S * B)
    print(f"edge per-scenario R={EDGE_R} B={S * B} ({S} start states from "
          f"batch_states in {secs['batch_states']:.2f} s, each at D/r0 "
          f"{', '.join(f'{d:g}' for d in EDGE_D_GRID)}) steps={n}: "
          f"{secs['per_scenario_run']:.4f} s, "
          f"{1e3 * secs['per_scenario_run'] / n:.3f} ms a step, "
          f"{S * B * n / secs['per_scenario_run']:.1f} solves/s, "
          f"psf_div3_sym launches {launches['per-scenario']} [{card}]")
    sx = out.strehl_exact[:, s0:].double().mean(dim=1).view(S, B).cpu()
    for j, d in enumerate(EDGE_D_GRID):
        col = sx[:, j]
        med = float(col.median())
        floor = EDGE_MIN_STREHL.get(d)
        print(f"edge realizations D/r0={d:g}: settled exact Strehl median "
              f"{med:.5f}, min {float(col.min()):.5f}, max "
              f"{float(col.max()):.5f} over {S} start states"
              + (f", {int((col >= floor).sum())} at or above the floor "
                 f"{floor}" if floor else ", not held")
              + f" (JAX {JAX_EDGE[d]}) [{card}]")
        if floor is not None and not med >= floor:
            fail(f"edge realizations D/r0={d:g}: median settled exact "
                 f"Strehl {med:.5f} < {floor}")
    last = EDGE_PS_LAST
    res = out.rms_res[:, -last:].mean(dim=1).view(S, B)[:, 0]
    turb = out.rms_turb[:, -last:].mean(dim=1).view(S, B)[:, 0]
    print(f"edge per-scenario D/r0=5: residual over the last {last} steps "
          f"{float(res.min()):.5f}-{float(res.max()):.5f} rad against "
          f"turbulence {float(turb.min()):.5f}-{float(turb.max()):.5f} rad "
          f"[{card}]")
    if not bool((res < 0.5 * turb).all()):
        fail("edge per-scenario D/r0=5: a residual is not below half the "
             "turbulence")

    t0 = time.perf_counter()
    edge_stream(model, state, dev, card)
    secs["stream"] = time.perf_counter() - t0

    def window():
        return shared(scen, EDGE_TRACE_STEPS)
    t0 = time.perf_counter()
    window()
    secs["window_run"] = window_s = time.perf_counter() - t0
    trace_secs, _ = trace_run(
        f"{EDGE_TRACE_STEPS}-step window of the edge rows, R={EDGE_R}, "
        f"B={B}", window, window_s, card, TRACE_DIR / "edge",
        EDGE_TRACE_SHARES)
    secs.update(trace_secs)
    secs["reference_card"], secs["reference_cpu"] = reference_phase(
        system.loop, None, cfg, dev, f"edge, R={EDGE_R}",
        n_steps=EDGE_REF_STEPS, edge=(model, state))
    total = time.time() - t_phase
    print(f"edge: phase in {total:.2f} s: " + ", ".join(
        f"{k} {v:.2f}" for k, v in secs.items())
        + f", other {total - sum(secs.values()):.2f} s")
    return launches


def settled(out) -> dict:
    """Settled (second half) exact Strehl, residual and turbulence RMS,
    and the count of diverged scenarios (non-finite, or a settled
    residual above 10x the turbulence), of a (B, steps, ...) run."""
    s = out.rms_res.shape[1] // 2
    res = out.rms_res[:, s:].mean(dim=1)
    turb = out.rms_turb[:, s:].mean(dim=1)
    ok = torch.isfinite(res) & (res <= 10.0 * turb)
    return {"strehl": float(out.strehl_exact[:, s:].mean()),
            "rms_res": float(res.mean()), "rms_turb": float(turb.mean()),
            "diverged": int((~ok).sum())}


def solver_cfg(cfg, **mpc_kw):
    return cfg.replace(mpc=dataclasses.replace(cfg.mpc, **mpc_kw))


def solvers_phase(system, cfg, fixed: dict, dev, card) -> dict:
    """ROADMAP A.8: every solver of the loop's switch through B1, each run
    counted -- B1's launches and the solver calls (``count_solver_calls``)
    -- then timed warm; B=4 card-vs-CPU checks on each new route.

    (a) the bench configuration (the slice build), B=4096, 25 steps: the
        general Newton solve (newton_steps=2) and ADMM (400 iterations,
        default rho), each against ``fixed``, the slice phase's settled
        numbers of the fixed Newton step on the same build and scenarios;
    (b) BASELINE config 1 (tests/test_configs.py:26-39): VAR(1) with the
        ramp rows (fastmpc_ramp), R=128, its own build, B=1024, 60 steps;
    (c) MODES_r04.json's order=10_N=32 cells (benchmarks/modes_horizon.py
        :98-160): radial order 10, the high-order recipe, N=32 through
        with_horizon, fixed and general_cr (newton_steps=2: cyclic
        reduction), B=64, 200 steps from the warm start.
    Returns B1's launches in each counted run."""
    t_phase = time.time()
    secs = {}
    b1 = K.psf_crop_diversity_sym3
    launches = {}

    def counted(label, run, steps, calls):
        """run() once with the counts at 0 (B1 launches exactly ``steps``
        and the solvers are called exactly ``calls`` times, or fail), then
        once warm; returns the first output."""
        reset_launches()
        with count_solver_calls() as got:
            t0 = time.perf_counter()
            out = run()
            first_s = time.perf_counter() - t0
        launches[label] = b1.launches
        want = {name: calls.get(name, 0) for name in got}
        print(f"solvers {label}: solver calls in the first run {got} "
              f"(expected {want})")
        if got != want:
            fail(f"the {label} run called the solvers {got}, not {want}")
        t0 = time.perf_counter()
        run()
        warm_s = time.perf_counter() - t0
        B = out.u.shape[0]
        print(f"solvers {label}: warm run {warm_s:.4f} s "
              f"({B * out.u.shape[1] / warm_s:.1f} solves/s, "
              f"{1e3 * warm_s / out.u.shape[1]:.3f} ms a step; first run "
              f"{first_s:.4f} s), psf_div3_sym launches {launches[label]} "
              f"in the first [{card}]")
        if launches[label] != steps:
            fail(f"the {label} run launched psf_div3_sym {launches[label]} "
                 f"times, not {steps}")
        for field_name, field in zip(out._fields, out):
            if not bool(torch.isfinite(field).all()):
                fail(f"the {label} run gave a non-finite {field_name}")
        secs[label] = first_s + warm_s
        return out

    # (a) the bench configuration through each solver
    scen = montecarlo.make_scenarios(cfg, torch.Generator().manual_seed(1),
                                     BATCH, device=dev)
    runs = {"newton_steps=2": (solver_cfg(cfg, newton_steps=2),
                               {"solve": STEPS}),
            "admm": (solver_cfg(cfg, solver="admm"),
                     {"admm_condensed": STEPS})}
    bench = {}
    for label, (c, calls) in runs.items():
        out = counted(label, lambda c=c: run_loop(system, c, scen, STEPS),
                      STEPS, calls)
        bench[label] = settled(out)
        bench[label]["du"] = float(out.du[:, 1:].abs().max())
        print(f"solvers {label}: R={cfg.resolution} B={BATCH} "
              f"steps={STEPS}: settled exact Strehl "
              f"{bench[label]['strehl']:.5f}, residual RMS "
              f"{bench[label]['rms_res']:.5f} rad, max|du[1:]| "
              f"{bench[label]['du']:.4f} rad (du_max {cfg.mpc.du_max})")
    print(f"solvers: the fixed step (slice phase, B1): settled exact "
          f"Strehl {fixed['strehl']:.5f}, residual RMS "
          f"{fixed['rms_res']:.5f} rad")
    gap = abs(bench["newton_steps=2"]["strehl"] - fixed["strehl"])
    print(f"solvers: newton_steps=2 vs the fixed step: settled exact "
          f"Strehl differs by {gap:.2e} (limit {ROUTE_STREHL_TOL})")
    if gap > ROUTE_STREHL_TOL:
        fail(f"newton_steps=2 settles {gap:.5f} from the fixed step")
    admm = bench["admm"]
    d_res = abs(admm["rms_res"] - fixed["rms_res"])
    print(f"solvers: admm vs the fixed step: settled residual RMS differs "
          f"by {d_res:.4f} rad (limit {ADMM_RES_TOL}); max|du[1:]| "
          f"{admm['du']:.4f} (limit {ADMM_DU_SLACK} du_max = "
          f"{ADMM_DU_SLACK * cfg.mpc.du_max:.4f})")
    if d_res > ADMM_RES_TOL or admm["du"] > ADMM_DU_SLACK * cfg.mpc.du_max:
        fail("the admm loop misses its residual or ramp limit")
    for label, n in (("newton_steps=2", STEPS), ("admm", ADMM_REF_STEPS)):
        secs[f"reference {label}"] = sum(reference_phase(
            system.loop, system.layers, runs[label][0], dev, label,
            n_steps=n))
    secs["trace admm"] = trace_window(
        f"{ADMM_TRACE_STEPS}-step ADMM run, B={BATCH}",
        lambda: run_loop(system, runs["admm"][0], scen, ADMM_TRACE_STEPS),
        card, "solvers_admm")

    # (b) BASELINE config 1: VAR(1) + the ramp rows
    c = solver_cfg(roofline.bench_cfg(128), var_order=1,
                   solver="fastmpc_ramp")
    c = c.replace(sim=dataclasses.replace(c.sim, n_test=RAMP_STEPS))
    ramp_sys, secs["ramp build"] = build_timed("solvers ramp", c, dev)
    a2 = float(ramp_sys.loop.prob.A2.abs().max())
    scen = montecarlo.make_scenarios(c, torch.Generator().manual_seed(1),
                                     RAMP_BATCH, device=dev)
    gn = c.estimator.gauss_newton_iters
    out = counted("fastmpc_ramp (VAR(1))",
                  lambda: run_loop(ramp_sys, c, scen, RAMP_STEPS),
                  RAMP_STEPS * (1 + gn), {"solve": RAMP_STEPS})
    du = float(out.du.abs().max())
    res10 = float(out.rms_res[:, -10:].mean())
    turb10 = float(out.rms_turb[:, -10:].mean())
    print(f"solvers fastmpc_ramp (VAR(1)): R={c.resolution} B={RAMP_BATCH} "
          f"steps={RAMP_STEPS}: max|A2| {a2:g}; settled exact Strehl "
          f"{settled(out)['strehl']:.5f}; max|du| {du:.4f} rad (limit 1.01 "
          f"du_max = {1.01 * c.mpc.du_max:.4f}); residual RMS over the last "
          f"10 steps {res10:.4f} rad, 0.75x the turbulence {0.75 * turb10:.4f}")
    if a2 != 0.0 or du > 1.01 * c.mpc.du_max or not res10 < 0.75 * turb10:
        fail("the VAR(1) ramp loop misses a limit of tests/test_configs.py")
    secs["reference fastmpc_ramp"] = sum(reference_phase(
        ramp_sys.loop, ramp_sys.layers, c, dev, "fastmpc_ramp (VAR(1))"))
    del ramp_sys, out

    # (c) MODES order 10, N=32: fixed and general_cr
    c = modes_cfg()
    modes_sys, secs["modes build"] = build_timed("solvers modes", c, dev)
    t0 = time.time()
    modes_sys = pipeline.with_horizon(modes_sys, c)
    torch.cuda.synchronize()
    secs["modes with_horizon"] = time.time() - t0
    print(f"solvers modes: with_horizon(N={c.mpc.horizon}) in "
          f"{secs['modes with_horizon']:.2f} s [{card}]")
    start = c.sim.n_train + c.sim.n_valid
    init_u = pipeline.warm_start_command(modes_sys, c, start)
    n = c.sim.n_test
    f32 = dict(dtype=torch.float32, device=dev)
    scen = montecarlo.ScenarioBatch(
        start_step=torch.full((MODES_BATCH,), float(start), **f32),
        mag=torch.full((MODES_BATCH,), c.sim.magnification, **f32),
        noise_scale=torch.ones((MODES_BATCH,), **f32), noise_seed=1)
    gn = c.estimator.gauss_newton_iters
    for tag, newton_steps in (("fixed", 1), ("general_cr", 2)):
        cn = solver_cfg(c, newton_steps=newton_steps)
        label = f"modes order=10_N=32_{tag}"
        # fixed: the precomputed step; general_cr: the general solve, whose
        # every Newton step's Schur solve is one cyclic reduction
        calls = ({"solve_fixed": n} if newton_steps == 1 else
                 {"solve": n, "banded_solve": n * newton_steps})
        out = counted(label, lambda cn=cn: run_loop(
            modes_sys, cn, scen, n, init_u), n * (1 + gn), calls)
        got = settled(out)
        target = MODES_TARGET[tag]
        print(f"solvers {label}: R={c.resolution} B={MODES_BATCH} steps={n}:"
              f" settled exact Strehl {got['strehl']:.5f} (quality target "
              f"{target}, limit +-{MODES_STREHL_TOL}), residual RMS "
              f"{got['rms_res']:.4f} rad, rejection "
              f"{got['rms_turb'] / got['rms_res']:.3f}, {got['diverged']} "
              f"diverged")
        if got["diverged"] or abs(got["strehl"] - target) > MODES_STREHL_TOL:
            fail(f"{label} misses its quality target")
    secs["trace general_cr"] = trace_window(
        f"{MODES_TRACE_STEPS}-step general_cr run, N=32, B={MODES_BATCH}",
        lambda: run_loop(modes_sys, cn, scen, MODES_TRACE_STEPS, init_u),
        card, "solvers_general_cr")
    secs["reference general_cr"] = sum(reference_phase(
        modes_sys.loop, modes_sys.layers, cn, dev, "modes general_cr, N=32",
        n_steps=MODES_REF_STEPS,
        mag=torch.full((4,), c.sim.magnification), init_u=init_u))
    total = time.time() - t_phase
    print(f"solvers: phase in {total:.2f} s: " + ", ".join(
        f"{k} {v:.2f}" for k, v in secs.items())
        + f", other {total - sum(secs.values()):.2f} s [{card}]")
    return launches


@contextlib.contextmanager
def count_solver_calls():
    """Within the block, count the calls of each solver the loop's switch
    can reach -- newton_kkt.solve_fixed and solve, block_tridiag.
    banded_solve (the cyclic reduction inside solve's Newton steps) and
    solvers.admm_condensed -- in the dict it yields."""
    sites = [(newton_kkt, "solve_fixed"), (newton_kkt, "solve"),
             (block_tridiag, "banded_solve"), (solvers, "admm_condensed")]
    counts = {name: 0 for _, name in sites}

    def counting(name, fn):
        def call(*args, **kwargs):
            counts[name] += 1
            return fn(*args, **kwargs)
        return call
    originals = [(module, name, getattr(module, name))
                 for module, name in sites]
    for module, name, fn in originals:
        setattr(module, name, counting(name, fn))
    try:
        yield counts
    finally:
        for module, name, fn in originals:
            setattr(module, name, fn)


def trace_window(label: str, run, card: str, name: str) -> float:
    """An untraced, then a traced run() (trace_run): where a solver's
    step spends its time.  Returns the seconds both took."""
    t0 = time.perf_counter()
    run()
    untraced_s = time.perf_counter() - t0
    trace_run(label, run, untraced_s, card, TRACE_DIR / name)
    return time.perf_counter() - t0


def parallel_phase(system, cfg, dev, card) -> dict:
    """ROADMAP A.10 on the card, through B1: (a) a world of one rank under
    NCCL on cuda:0 -- run_sharded over the slice batch (B=4096, 25 steps,
    verified shared window) held to run_batch's reduction of the same
    batch within PARALLEL_RTOL, a scenario with a NaN magnification
    counted in n_diverged and kept out of the means, dryrun_multichip(1);
    (b) PARALLEL_RANKS spawned ranks sharing cuda:0 over gloo (NCCL
    refuses two ranks on one card), each restoring the slice system from
    a checkpoint, run_sharded over the same 4096 scenarios (2048 a rank),
    held to (a)'s one-process statistics.  Any failed init, dead rank or
    timed-out collective fails the smoke.  Returns B1's launches per
    run."""
    t_phase = time.time()
    b1 = K.psf_crop_diversity_sym3
    launches = {}
    scen = montecarlo.make_scenarios(cfg, torch.Generator().manual_seed(1),
                                     BATCH, device=dev)
    with tempfile.TemporaryDirectory(prefix="smoke_world_") as tmp:
        dist.init_process_group(
            "nccl", init_method=f"file://{os.path.join(tmp, 'store')}",
            world_size=1, rank=0, timeout=multihost.TIMEOUT)
        try:
            mesh = mesh_lib.scenario_mesh(device_type="cuda")
            runner = montecarlo.make_sharded_runner(
                system.loop, system.layers, cfg, STEPS, mesh,
                shared_window=True)
            reset_launches()
            stats = runner(scen).as_floats()
            launches["nccl"] = b1.launches
            if b1.launches != STEPS:
                fail(f"parallel (a): B1 launched {b1.launches} times in "
                     f"{STEPS} steps")
            warm = []
            for _ in range(PARALLEL_TIMED):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                float(runner(scen).mean_rms_res)
                warm.append(time.perf_counter() - t0)
            out = montecarlo.run_batch(system.loop, system.layers, cfg,
                                       scen, STEPS, shared_window="verified")
            one = montecarlo.reduce_stats(out, STEPS).as_floats()
            try:
                delta = multiprocess.max_rel_delta(stats, one)
            except AssertionError as e:
                fail(f"parallel (a): NCCL world of 1 vs run_batch: {e}")
            print(f"parallel (a): NCCL world of 1 on cuda:0, B={BATCH}, "
                  f"{STEPS} steps: settled exact Strehl "
                  f"{stats['mean_strehl_exact']:.5f}, residual "
                  f"{stats['mean_rms_res']:.5f} rad, "
                  f"{stats['n_scenarios']:.0f} kept, "
                  f"{stats['n_diverged']:.0f} diverged; max relative "
                  f"delta to run_batch {delta:.3g} (limit {PARALLEL_RTOL}); "
                  f"B1 launches {launches['nccl']}; warm "
                  f"{1e3 * min(warm) / STEPS:.3f} ms a step (runs "
                  f"{[round(w, 4) for w in warm]} s) [{card}]")
            mag = scen.mag.clone()
            mag[0] = float("nan")
            bad = runner(scen._replace(mag=mag)).as_floats()
            if not (bad["n_diverged"] >= 1
                    and bad["n_scenarios"] + bad["n_diverged"] == BATCH
                    and np.isfinite(bad["mean_rms_res"])
                    and bad["mean_rms_res"] < 10.0):
                fail(f"parallel (a): the poisoned scenario was not "
                     f"contained: {bad}")
            print(f"parallel (a): poisoned scenario contained: "
                  f"{bad['n_diverged']:.0f} diverged, "
                  f"{bad['n_scenarios']:.0f} kept, residual "
                  f"{bad['mean_rms_res']:.5f} rad")
        finally:
            dist.destroy_process_group()
    t0 = time.time()
    dry = dryrun.dryrun_multichip(1, device="cuda:0")[0]
    print(f"parallel (a): dryrun_multichip(1) under NCCL in "
          f"{time.time() - t0:.2f} s: DP {dry['dp']['n_scenarios']:.0f} "
          f"scenarios, conditional "
          f"{dry['dp_conditional']['n_scenarios']:.0f}, ramp "
          f"{dry['dp_ramp']['n_scenarios']:.0f}, cyclic reduction "
          f"{dry['dp_cyclic_reduction']['n_scenarios']:.0f}, TP max error "
          f"{dry['tp_max_abs_err']:.3g}, horizon residual "
          f"{dry['hz_max_residual']:.3g}")

    # (b) two ranks sharing the card over gloo, from a checkpoint
    system_dir = str(PARALLEL_DIR / "slice_system")
    multiprocess.save_system(system_dir, system, cfg)
    job = {"system_dir": system_dir, "n_scenarios": BATCH,
           "n_steps": STEPS, "d_grid": (5.0,), "snr_grid": (10.0,),
           "seed": 1, "timed": PARALLEL_TIMED}
    t0 = time.time()
    ranks = multihost.spawn(multiprocess.sharded_stats, PARALLEL_RANKS,
                            backend="gloo", device="cuda:0", args=(job,),
                            timeout=600.0)
    spawn_s = time.time() - t0
    launches["gloo_2_ranks"] = sum(r["launches"] for r in ranks)
    for rank, r in enumerate(ranks):
        try:
            delta = multiprocess.max_rel_delta(r["stats"], one)
        except AssertionError as e:
            fail(f"parallel (b): rank {rank} vs the one-process run: {e}")
        if r["launches"] != STEPS:
            fail(f"parallel (b): rank {rank} launched B1 {r['launches']} "
                 f"times in {STEPS} steps")
        print(f"parallel (b): rank {rank} of {PARALLEL_RANKS} (gloo, "
              f"cuda:0, {BATCH // PARALLEL_RANKS} of {BATCH} scenarios): "
              f"settled exact Strehl {r['stats']['mean_strehl_exact']:.5f}; "
              f"max relative delta to (a)'s one-process run {delta:.3g} "
              f"(limit {PARALLEL_RTOL}); B1 launches {r['launches']}; warm "
              f"{1e3 * min(r['warm_s']) / STEPS:.3f} ms a step (runs "
              f"{[round(w, 4) for w in r['warm_s']]} s) [{card}]")
    print(f"parallel (b): spawn to results {spawn_s:.2f} s; parallel phase "
          f"{time.time() - t_phase:.2f} s")
    return launches


def population_phase(card) -> dict:
    """The port's benchmarks/montecarlo_100k.py on the card, cut to
    POPULATION_ENV (12,800 scenarios x 100 steps at R=128, through B1):
    each cell's mean / p10 settled exact Strehl and diverged count beside
    MONTECARLO_r04.json's (held: 0 diverged, mean within POPULATION_TOL);
    then the D/r0=5 part stopped after one chunk (MC1_STOP_AFTER=1) and
    resumed from its checkpoint, its summaries bit-identical to the
    uninterrupted run's.  Returns B1's launches per run."""
    t_phase = time.time()
    b1 = K.psf_crop_diversity_sym3
    ref = json.loads(POPULATION_REF.read_text())["cells"]
    ckpt = PARALLEL_DIR / "population"
    shutil.rmtree(ckpt, ignore_errors=True)
    launches = {}
    reset_launches()
    full = montecarlo_100k.main(
        [str(POPULATION_R)], dict(POPULATION_ENV, MC1_CKPT=str(ckpt / "full")))
    launches["full"] = b1.launches
    n_chunks = int(POPULATION_ENV["MC1_REPS"]) // int(
        POPULATION_ENV["MC1_CHUNK"])
    steps = int(POPULATION_ENV["MC1_STEPS"])
    # B1 measures once a step and once more a Gauss-Newton pass
    per_step = 1 + montecarlo_100k.tuned_cfg(
        POPULATION_R, 5.0, steps).estimator.gauss_newton_iters
    want = (n_chunks * len(POPULATION_ENV["MC1_DR0"].split(",")) * steps
            * per_step)
    if b1.launches != want:
        fail(f"population: B1 launched {b1.launches} times, not {want}")
    for d, v in full["per_d"].items():
        print(f"population {d}: build {v['build_s']:.2f} s, loop "
              f"{v['loop_s']:.2f} s, {v['solves_per_s']:.1f} solves/s "
              f"[{card}]")
    print(f"population: {full['n_scenarios']} scenarios x "
          f"{full['n_steps']} steps at R={POPULATION_R}: loop "
          f"{full['total_loop_s']:.2f} s, wall {full['total_wall_s']:.2f} s, "
          f"{full['aggregate_solves_per_s']:.1f} solves/s; B1 launches "
          f"{b1.launches} [{card}]")
    for name, cell in full["cells"].items():
        r = ref[name]
        print(f"population {name}: mean {cell.get('mean_strehl')} p10 "
              f"{cell.get('p10_strehl')} diverged {cell['n_diverged']} of "
              f"{cell['n']} (MONTECARLO_r04.json: mean {r['mean_strehl']} "
              f"p10 {r['p10_strehl']} diverged {r['n_diverged']} of "
              f"{r['n']})")
        if cell["n_diverged"] or abs(cell["mean_strehl"]
                                     - r["mean_strehl"]) > POPULATION_TOL:
            fail(f"population {name}: {cell} against MONTECARLO_r04.json "
                 f"{r} (0 diverged, mean within {POPULATION_TOL})")
    # kill and resume the D/r0=5 part
    env5 = dict(POPULATION_ENV, MC1_DR0="5", MC1_CKPT=str(ckpt / "resume"))
    reset_launches()
    t0 = time.time()
    try:
        montecarlo_100k.main([str(POPULATION_R)],
                             dict(env5, MC1_STOP_AFTER="1"))
        fail("population: MC1_STOP_AFTER=1 did not stop the run")
    except SystemExit as e:
        if e.code != montecarlo_100k.STOPPED:
            raise
    resumed = montecarlo_100k.main([str(POPULATION_R), "--resume"], env5)
    launches["resume"] = b1.launches
    if not np.array_equal(resumed["summaries"][0], full["summaries"][0]):
        diff = np.abs(resumed["summaries"][0] - full["summaries"][0])
        fail(f"population: the resumed D/r0=5 summaries differ from the "
             f"uninterrupted run's (max {np.nanmax(diff):.3g}, "
             f"{int((diff != 0).sum())} entries)")
    print(f"population: D/r0=5 stopped after 1 chunk and resumed at cursor "
          f"{resumed['resumed_at_cursor']}: summaries bit-identical to the "
          f"uninterrupted run's; B1 launches {b1.launches} in "
          f"{time.time() - t0:.2f} s; population phase "
          f"{time.time() - t_phase:.2f} s")
    return launches


def classical_phase(dev, card) -> dict:
    """The port's benchmarks/classical_vs_mpc.py rows at the JAX script's
    size (R=128, D/r0 5 and 10, 500 steps, n_train/n_valid 1000/500, the
    strong recipe at D/r0=10; SH with 8 lenslets, since 128 is not a
    multiple of 10; gains 0.3/0.5/0.7): the MPC's settled exact Strehl
    within CLASSICAL_STREHL_TOL, the ideal integrator's best gain 0.7 and
    its residual within 1%, the noise-matched one within 3% of
    CLASSICAL_r05.json's, both advantages > 1, and B1's launches exact.
    Then the card against the CPU (SH slopes and the integrator on the
    D/r0=5 window, the pyramid at R=64) and the detector's noise law on a
    cuda generator.  Writes the report to chiprun_out/ and returns B1's
    launches per row."""
    t_phase = time.time()
    b1 = K.psf_crop_diversity_sym3
    ref = json.loads(CLASSICAL_REF.read_text())["rows"]
    report = {"resolution": CLASSICAL_R, "n_steps": CLASSICAL_STEPS,
              "device": card, "rows": {}}
    launches = {}
    for d in CLASSICAL_D:
        cfg = classical_vs_mpc.row_cfg(CLASSICAL_R, d, CLASSICAL_STEPS)
        reset_launches()
        row = classical_vs_mpc.row(cfg, dev)
        key = f"d_over_r0={d:g}"
        report["rows"][key] = row
        launches[f"d={d:g}"] = b1.launches
        # pipeline.build launches no kernel (the estimator linearizes with
        # float64 matmuls, warm_start_command is host numpy); the loop
        # measures once a step and once more a Gauss-Newton pass
        want = CLASSICAL_STEPS * (1 + cfg.estimator.gauss_newton_iters)
        got = (row["b1_launches_build"], row["mpc"]["b1_launches"],
               b1.launches)
        if got != (0, want, want):
            fail(f"classical {key}: B1 launched (build, loop, row) {got}, "
                 f"not (0, {want}, {want})")
        r, m = ref[key], row["mpc"]
        ideal, noisy = row["integrator"], row["integrator_snr_matched"]
        print(f"classical {key}: build {row['build_s']:.2f} s; MPC loop "
              f"{m['ms_per_step']:.3f} ms a step, settled exact Strehl "
              f"{m['strehl_exact']:.5f} (JAX {r['mpc']['strehl_exact']}), "
              f"residual {m['mean_rms_res']:.5f} rad (JAX "
              f"{r['mpc']['mean_rms_res']}), B1 launches {b1.launches} "
              f"[{card}]")
        for label in ("integrator", "integrator_snr_matched"):
            for run in row["runs"][label]:
                print(f"classical {key} {label} gain {run['gain']}: "
                      f"residual {run['mean_rms_res']:.5f} rad, "
                      f"{run['ms_per_step']:.4f} ms a step [{card}]")
        print(f"classical {key}: best ideal gain {ideal['gain']} residual "
              f"{ideal['mean_rms_res']:.5f} (JAX "
              f"{r['integrator']['mean_rms_res']}), noise-matched gain "
              f"{noisy['gain']} {noisy['mean_rms_res']:.5f} (JAX "
              f"{r['integrator_snr_matched']['mean_rms_res']}); MPC "
              f"advantage {row['mpc_advantage_rms']:.4f} / "
              f"{row['mpc_advantage_rms_snr_matched']:.4f} (JAX "
              f"{r['mpc_advantage_rms']} / "
              f"{r['mpc_advantage_rms_snr_matched']})")
        checks = {
            "MPC Strehl": abs(m["strehl_exact"] - r["mpc"]["strehl_exact"])
            <= CLASSICAL_STREHL_TOL,
            "ideal gain": ideal["gain"] == CLASSICAL_GAIN,
            "ideal residual": abs(ideal["mean_rms_res"]
                                  / r["integrator"]["mean_rms_res"] - 1)
            <= CLASSICAL_IDEAL_RTOL,
            "noise-matched residual": abs(
                noisy["mean_rms_res"]
                / r["integrator_snr_matched"]["mean_rms_res"] - 1)
            <= CLASSICAL_NOISY_RTOL,
            "advantage": row["mpc_advantage_rms"] > 1
            and row["mpc_advantage_rms_snr_matched"] > 1}
        failed = [k for k, ok in checks.items() if not ok]
        if failed:
            fail(f"classical {key}: {failed} against CLASSICAL_r05.json")
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "classical_vs_mpc.json").write_text(
        json.dumps(report, indent=2) + "\n")

    # card against CPU on the D/r0=5 window, TF32 off
    cfg = classical_vs_mpc.row_cfg(CLASSICAL_R, CLASSICAL_D[0],
                                   CLASSICAL_CPU_STEPS)
    system = pipeline.build(cfg, dev)
    sh, stack, vault = classical_vs_mpc.classical_setup(system, cfg)
    flat = classical_vs_mpc.turbulence_window(system, cfg,
                                              CLASSICAL_CPU_STEPS)
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    noise = 0.02 * torch.randn((CLASSICAL_CPU_STEPS, sh.n_slopes),
                               generator=gen, device=dev)
    mask = system.loop.mask.reshape(-1)
    cpu = torch.device("cpu")
    cpu_vault = dataclasses.replace(vault, M=vault.M.to(cpu))
    for gain in classical_vs_mpc.GAINS:
        icfg = integrator.IntegratorConfig(gain=gain)
        got = integrator.closed_loop(sh.slope_op, vault, stack, flat, icfg,
                                     mask_flat=mask, slope_noise=noise)
        want = integrator.closed_loop(
            sh.slope_op.to(cpu), cpu_vault, stack.to(cpu), flat.to(cpu),
            icfg, mask_flat=mask.to(cpu), slope_noise=noise.to(cpu))
        for name, g, w in zip(("c_acc", "rms"), got, want):
            # |card - CPU| <= rtol (|CPU| + max|CPU|)
            err = float(((g.cpu() - w).abs()
                         / (w.abs() + w.abs().max())).max())
            if not err <= CLASSICAL_RTOL:
                fail(f"classical: integrator gain {gain} {name} on the card "
                     f"is {err:.3g} off the CPU's (rtol {CLASSICAL_RTOL})")
    print(f"classical: integrator on the card vs the CPU, "
          f"{CLASSICAL_CPU_STEPS}-step window with injected slope noise, "
          f"gains {classical_vs_mpc.GAINS}: c_acc and rms within rtol "
          f"{CLASSICAL_RTOL}")

    phase = flat[:1].reshape(1, CLASSICAL_R, CLASSICAL_R)
    sh_cpu = wfs.build(CLASSICAL_R, n_lenslet=8, device=cpu)
    ref_slopes = (wfs.reference_slopes(sh), wfs.reference_slopes(sh_cpu))
    paths = {
        "geometric": lambda m, x, r: wfs.geometric_slopes(m, x),
        "diffractive": lambda m, x, r: wfs.diffractive_slopes(m, x),
        "camera": lambda m, x, r: wfs.camera_slopes(
            m, x, None, threshold=(0.01, 0.1), ref_slopes=r)}
    for name, fn in paths.items():
        got = fn(sh, phase, ref_slopes[0])
        want = fn(sh_cpu, phase.cpu(), ref_slopes[1])
        err = float((got.cpu() - want).abs().max() / want.abs().max())
        ms = profiling.cuda_time_ms(lambda: fn(sh, phase, ref_slopes[0]), 20)
        print(f"classical: SH {name} slopes R={CLASSICAL_R}, 8 lenslets, "
              f"B=1: {ms:.4f} ms a call; card vs CPU max err {err:.3g} of "
              f"the peak [{card}]")
        if not err <= CLASSICAL_RTOL:
            fail(f"classical: SH {name} slopes on the card are {err:.3g} of "
                 f"the peak off the CPU's")
    lo = (CLASSICAL_R - PYRAMID_R) // 2       # a square inside the pupil
    screen = phase[0, lo:lo + PYRAMID_R, lo:lo + PYRAMID_R]
    for modulation in (0.0, 3.0):
        pyr = pyramid.build(PYRAMID_R, PYRAMID_NL, modulation=modulation,
                            device=dev)
        pyr_cpu = pyramid.build(PYRAMID_R, PYRAMID_NL,
                                modulation=modulation, device=cpu)
        got = pyramid.slopes(pyr, screen)
        want = pyramid.slopes(pyr_cpu, screen.cpu())
        err = float((got.cpu() - want).abs().max() / want.abs().max())
        ms = profiling.cuda_time_ms(lambda: pyramid.slopes(pyr, screen), 20)
        print(f"classical: pyramid slopes R={PYRAMID_R}, {PYRAMID_NL} "
              f"lenslets, modulation {modulation:g} "
              f"({pyr.phasors.shape[0]} steps), B=1: {ms:.4f} ms a call; "
              f"card vs CPU max err {err:.3g} of the peak [{card}]")
        if not err <= CLASSICAL_RTOL:
            fail(f"classical: pyramid slopes (modulation {modulation:g}) "
                 f"on the card are {err:.3g} of the peak off the CPU's")

    # the detector's noise law on a cuda generator (tests/test_imaging.py)
    gen.manual_seed(1)
    for label, det, flux, mean, var in (
            ("photon", imaging.DetectorConfig(64, photon_noise=True), 50.0,
             50.0, 50.0),
            ("QE", imaging.DetectorConfig(64, photon_noise=True,
                                          quantum_efficiency=0.5), 100.0,
             50.0, 25.0),
            ("readout", imaging.DetectorConfig(64, read_out_noise=3.0), 0.0,
             0.0, 9.0)):
        out = imaging.read_out(det, gen, torch.full((64, 64), flux,
                                                    device=dev)).cpu()
        got_mean, got_var = float(out.mean()), float(out.var(correction=0))
        print(f"classical: read_out {label} noise on the card: mean "
              f"{got_mean:.4f} (want {mean}), variance {got_var:.4f} "
              f"(want {var})")
        if not (abs(got_mean - mean) <= max(0.02 * mean, 0.15)
                and abs(got_var - var) <= 0.1 * var):
            fail(f"classical: read_out {label} noise misses its law")
    print(f"classical: phase {time.time() - t_phase:.2f} s")
    return launches


def a12_frames(atm, pitch, gs, dev):
    """The SH model and the (B, ...) geometric slopes [rad/px] of
    A12_BATCH frames as each reconstructor's system measures them: one
    window of A12_WINDOW px a frame (numpy-seeded FFT screens of twice
    that, no subharmonics, cut 2 x 2, made in host threads), seen on axis
    (NGS), projected at 8 km into the guide stars' directions ``gs``
    (tomographic) and onto the cone of the LGS at A12_LGS_H."""
    sh = wfs.build(A12_R, n_lenslet=A12_NL, device=dev)
    w = A12_WINDOW

    def windows(s):
        scr = phase_screens.synthesize_screen(s, atm, 2 * w, pitch,
                                              oversample=1,
                                              subharmonic_levels=0)
        return (scr.reshape(2, w, 2, w).transpose(0, 2, 1, 3)
                .reshape(4, w, w))
    # host threads: each screen is the same function of its seed
    with concurrent.futures.ThreadPoolExecutor(
            phase_screens.SCREEN_THREADS) as pool:
        wins = list(pool.map(windows, range(A12_BATCH // 4)))
    win = torch.as_tensor(np.concatenate(wins) * 0.3, device=dev)

    def seen(alt, **kw):
        return wfs.geometric_slopes(sh, relay.project_layers(
            [win], [pitch], 0.5, (alt,), A12_R, **kw))
    return sh, {"ngs": seen(0.0),
                "tomographic": torch.stack(
                    [seen(8000.0, direction=g) for g in gs], dim=1),
                "lgs": seen(8000.0, source_height=A12_LGS_H)}


def a12_phase(dev, card) -> dict:
    """The wavefront-sensing and MCAO slice (ROADMAP A.12) on the card:
    the two demos against the JAX demos' numbers (demo_reference.json),
    the three slopes-MMSE reconstructors on a 40x40 SH at R=320 with
    B=512 frames (CG depth, ms a batch, card against CPU), and card
    against CPU for the relay, the LGS spot elongation and the ray trace.
    Writes chiprun_out/a12.json and returns the report."""
    t_phase = time.time()
    ref = json.loads(A12_REF.read_text())
    report = {"device": card}

    # 1. the demos against the JAX demos' numbers
    t0 = time.time()
    w = wfs_demo.main(dev)
    m = mcao_demo.main(dev)
    report["demos"] = {"wfs": w, "mcao": m, "s": time.time() - t0}
    checks = [("MCAO piston-free", m["piston_free_var_rad2"],
               ref["mcao"]["piston_free_var_rad2"], A12_ANALYTIC_RTOL),
              ("MCAO SCAO", m["scao_var_rad2"], ref["mcao"]["scao_var_rad2"],
               A12_ANALYTIC_RTOL)]
    for dm in ("one_dm", "two_dm"):
        checks.append((f"MCAO {dm} field", m[dm]["mcao_var_rad2"],
                       ref["mcao"][dm]["mcao_var_rad2"], A12_ANALYTIC_RTOL))
        for k, (a, b) in enumerate(zip(m[dm]["target_vars_rad2"],
                                       ref["mcao"][dm]["target_vars_rad2"])):
            checks.append((f"MCAO {dm} direction {k}", a, b,
                           A12_ANALYTIC_RTOL))
    for k, (a, b) in enumerate(zip(m["monte_carlo_rad2"],
                                   ref["mcao"]["monte_carlo_rad2"])):
        checks.append((f"MCAO Monte-Carlo direction {k}", a, b, A12_MC_RTOL))
    checks += [("tomography error", w["tomography_error_rad2"],
                ref["wfs"]["tomography_error_rad2"], A12_TOMO_RTOL),
               ("tomography Strehl", w["tomography_strehl"],
                ref["wfs"]["tomography_strehl"], A12_TOMO_RTOL),
               ("slopes-MMSE RMS", w["mmse_rms"], ref["wfs"]["mmse_rms"],
                A12_CG_RMS_RTOL)]
    for name, got, want, rtol in checks:
        err = abs(got / want - 1)
        print(f"a12 demo: {name} {got:.6g} (JAX {want:.6g}, rel {err:.2e}, "
              f"rtol {rtol:g})")
        if not err <= rtol:
            fail(f"a12: {name} {got} is {err:.3g} off the JAX demo's {want}")
    print(f"a12: demos {report['demos']['s']:.2f} s [{card}]")

    # 2. slopes-MMSE at 40x40 lenslets, R=320, B=512
    cpu = torch.device("cpu")
    atm = AtmosphereConfig(fractional_r0=(1.0,), altitudes=(0.0,),
                           wind_speeds=(5.0,), wind_directions=(0.0,))
    atm_h = dataclasses.replace(atm, altitudes=(8000.0,))
    pitch = 1.0 / (A12_R - 1)
    th = 15 * np.pi / 180 / 3600
    gs = [(th, 0.0), (-th / 2, th * 0.866), (-th / 2, -th * 0.866)]
    t0 = time.time()
    sh, frames = a12_frames(atm, pitch, gs, dev)
    torch.cuda.synchronize()
    print(f"a12: {A12_BATCH} frames at R={A12_R}, {A12_NL}x{A12_NL} "
          f"lenslets ({sh.n_valid} valid) in {time.time() - t0:.2f} s")
    nv = (0.02 / pitch) ** 2                 # the demo's noise, 0.02 px
    limit = A12_RESIDUAL_SLACK * A12_TOL
    cases = {
        "ngs": (lambda d, k=1.0: slopes_mmse.build(
            atm, 1.0, A12_NL, sh.valid, k * nv, device=d),
            slopes_mmse.reconstruct, A12_MAXIT),
        "tomographic": (lambda d: slopes_mmse.build_tomographic(
            atm_h, 1.0, A12_NL, sh.valid, nv, gs, device=d),
            slopes_mmse.reconstruct_tomographic, 150),
        "lgs": (lambda d: slopes_mmse.build_lgs(
            atm_h, 1.0, A12_NL, sh.valid, nv, A12_LGS_H, device=d),
            slopes_mmse.reconstruct_lgs, A12_MAXIT)}
    report["slopes_mmse"] = {}
    for name, (build, rec, maxit) in cases.items():
        x = frames[name]
        t0 = time.time()
        model, model_cpu = build(dev), build(cpu)
        build_s = time.time() - t0
        phi = rec(model, x, pitch, A12_TOL, maxit)
        y, it = slopes_mmse.solve(model, x, pitch, A12_TOL, maxit)
        res = slopes_mmse.relative_residual(model, x, pitch, y)
        reps = 1 if name == "tomographic" else 2
        ms = profiling.cuda_time_ms(lambda: rec(model, x, pitch, A12_TOL,
                                                maxit), reps)
        it = it.cpu()
        row = {"build_s": build_s, "ms_per_batch": ms,
               "iterations_min": int(it.min()),
               "iterations_max": int(it.max()),
               "iterations_mean": float(it.float().mean()),
               "max_true_residual": float(res.max()),
               "map_rms_mean": float(phi.std(dim=(-2, -1)).mean())}
        if not torch.isfinite(phi).all() or phi.shape != (
                A12_BATCH, A12_NL + 1, A12_NL + 1):
            fail(f"a12: {name} gives {tuple(phi.shape)} or non-finite maps")
        if not row["max_true_residual"] <= limit:
            fail(f"a12: {name} true CG residual {row['max_true_residual']:.3g}"
                 f" over {A12_RESIDUAL_SLACK} x tol")
        # card against CPU on the first frames: the fixed depth at 1e-4
        # of each map's RMS; at tol, the card's answers solve the CPU's
        # system (the maps and depths of a float32 CG at tol 5e-2 are not
        # reproducible to rounding: read, not held)
        xs, xc = x[:A12_CPU_FRAMES], x[:A12_CPU_FRAMES].cpu()
        t0 = time.time()
        got = rec(model, xs, pitch, 0.0, A12_DEPTH)
        want = rec(model_cpu, xc, pitch, 0.0, A12_DEPTH)
        rms = want.pow(2).mean(dim=(-2, -1)).sqrt()
        err = float(((got.cpu() - want).abs().amax(dim=(-2, -1))
                     / rms).max())
        row["fixed_depth_err_of_rms"] = err
        if not err <= A12_MAP_RTOL:
            fail(f"a12: {name} at CG depth {A12_DEPTH} on the card is "
                 f"{err:.3g} of the RMS off the CPU's (rtol {A12_MAP_RTOL})")
        res_cpu = slopes_mmse.relative_residual(
            model_cpu, xc, pitch, y[:A12_CPU_FRAMES].cpu())
        row["card_answer_cpu_residual_max"] = float(res_cpu.max())
        if not row["card_answer_cpu_residual_max"] <= limit:
            fail(f"a12: {name}: the card's answers leave a residual of "
                 f"{float(res_cpu.max()):.3g} on the CPU's system (limit "
                 f"{limit:g})")
        want = rec(model_cpu, xc, pitch, A12_TOL, maxit)
        row["cpu_iterations"] = slopes_mmse.solve(
            model_cpu, xc, pitch, A12_TOL, maxit)[1].tolist()
        row["card_iterations"] = it[:A12_CPU_FRAMES].tolist()
        row["tol_run_rms_rel_err_max"] = float(
            (phi[:A12_CPU_FRAMES].std(dim=(-2, -1)).cpu()
             / want.std(dim=(-2, -1)) - 1).abs().max())
        if name == "ngs":
            # the control: twice the noise variance must fail the check
            y_c = slopes_mmse.solve(build(dev, 2.0), xs, pitch, A12_TOL,
                                    maxit)[0]
            res_c = slopes_mmse.relative_residual(model_cpu, xc, pitch,
                                                  y_c.cpu())
            row["control_2x_noise_cpu_residual"] = [float(res_c.min()),
                                                    float(res_c.max())]
            if not float(res_c.max()) > limit:
                fail(f"a12: the 2x noise-variance control passes the "
                     f"residual check ({float(res_c.max()):.3g} <= "
                     f"{limit:g})")
        row["cpu_check_s"] = time.time() - t0
        report["slopes_mmse"][name] = row
        print(f"a12 slopes-MMSE {name}: B={A12_BATCH}, {A12_NL}x{A12_NL}, "
              f"CG iterations {row['iterations_min']}-"
              f"{row['iterations_max']} (mean {row['iterations_mean']:.1f}),"
              f" {ms:.3f} ms a batch, true residual <= "
              f"{row['max_true_residual']:.4f}; card vs CPU on "
              f"{A12_CPU_FRAMES} frames: depth {A12_DEPTH} {err:.2e} of the "
              f"RMS, card answers' residual on the CPU's system <= "
              f"{row['card_answer_cpu_residual_max']:.4f}, depths "
              f"{row['card_iterations']} / {row['cpu_iterations']}, tol-run "
              f"map RMS differs by <= {row['tol_run_rms_rel_err_max']:.4f}"
              + (f", control residual {row['control_2x_noise_cpu_residual']}"
                 if name == "ngs" else "")
              + f"; build {build_s:.2f} s, CPU check "
              f"{row['cpu_check_s']:.2f} s [{card}]")

    # 3. card against CPU: relay, LGS elongation, ray trace
    rng = np.random.default_rng(0)
    scr = [torch.as_tensor(rng.normal(size=(8, n, n)), dtype=torch.float32)
           for n in (192, 160)]
    spots = wfs.spot_frames(sh, torch.as_tensor(rng.normal(
        0, 0.5, (2, A12_R, A12_R)), dtype=torch.float32, device=dev))
    heights = 1e3 * (np.arange(-5, 6) + 90.0)
    pos = lgs.subaperture_positions(A12_NL, 1.0)
    rays = torch.as_tensor(rng.normal(0, [0.02, 0.01], (A12_RAYS, 2)),
                           dtype=torch.float32)
    chain = [raytrace.free_space(0.3, stop_width=0.08),
             raytrace.curved_mirror(1.0, offset=0.002, stop_width=0.05),
             raytrace.thin_lens(0.2)]

    def relay_on(d, **kw):
        return relay.project_layers([s.to(d) for s in scr],
                                    [1 / 47, 1 / 40], 0.5, (0.0, 8000.0),
                                    48, **kw)

    def elongate_on(d, kw_px):
        ker = lgs.elongation_kernels(lgs.build(heights, launch=(-0.5, 0.0),
                                               device=d), pos, 2e-7, kw_px,
                                     1.5)
        return lgs.elongate_spots(spots.to(d), ker)

    paths = {
        "relay off-axis": lambda d: relay_on(d, direction=(5e-5, -2e-5)),
        "relay LGS cone": lambda d: relay_on(d, direction=(2e-5, 0.0),
                                             source_height=A12_LGS_H),
        "elongate_spots kw=8": lambda d: elongate_on(d, 8),
        "elongate_spots kw=9": lambda d: elongate_on(d, 9),
        "raytrace": lambda d: raytrace.trace(chain, rays.to(d))[0]}
    report["card_vs_cpu"] = {}
    for name, fn in paths.items():
        got, want = fn(dev), fn(cpu)
        err = float((got.cpu() - want).abs().max() / want.abs().max())
        ms = profiling.cuda_time_ms(lambda: fn(dev), 5)
        report["card_vs_cpu"][name] = {"err_of_peak": err, "ms": ms}
        print(f"a12: {name} {tuple(got.shape)}: {ms:.4f} ms a call; card vs "
              f"CPU max err {err:.3g} of the peak [{card}]")
        if not err <= A12_RTOL:
            fail(f"a12: {name} on the card is {err:.3g} of the peak off the "
                 f"CPU's")
    report["s"] = time.time() - t_phase
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "a12.json").write_text(json.dumps(report, indent=2) + "\n")
    r = report["slopes_mmse"]
    print("a12: " + json.dumps({
        "demos_ok": True, "mmse_rms": w["mmse_rms"],
        "mc_rad2": m["monte_carlo_rad2"],
        "ms_per_batch": {k: v["ms_per_batch"] for k, v in r.items()},
        "cg_iterations_mean": {k: v["iterations_mean"] for k, v in r.items()},
        "phase_s": report["s"], "device": card}))
    return report


def record(name: str) -> dict:
    """A JAX record file of the repository root."""
    return json.loads((ROOT / name).read_text())


def seed_spread(system, cfg, d: float, init_u, dev) -> tuple:
    """The build's loop over PROTO_SEEDS noise seeds as one batched run
    (the shared test window at mag_conv(d), from ``init_u``, noise seed
    2).  Returns (min, max) of the per-seed settled exact Strehl."""
    S = PROTO_SEEDS
    scen = _protocol.shared_scenarios(cfg, [mag_conv(d)] * S, [1.0] * S, 2,
                                      dev)
    out = run_loop(system, cfg, scen, cfg.sim.n_test, init_u)
    if not bool(torch.isfinite(out.rms_res).all()):
        fail(f"protocol: a seed of the D/r0={d:g} build gave a non-finite "
             f"residual")
    per = out.strehl_exact[:, cfg.sim.n_test // 2:].double().mean(dim=1)
    return float(per.min()), float(per.max())


def held_in(label: str, jax_v: float, lo: float, hi: float,
            widen: float, card: str) -> None:
    """The JAX row must lie within [lo - widen, hi + widen]."""
    ok = lo - widen <= jax_v <= hi + widen
    print(f"protocol {label}: {PROTO_SEEDS}-seed settled exact Strehl "
          f"{lo:.5f}-{hi:.5f}; JAX {jax_v} {'inside' if ok else 'OUTSIDE'}"
          f" the range widened by {widen} [{card}]")
    if not ok:
        fail(f"protocol {label}: JAX {jax_v} outside [{lo - widen:.5f}, "
             f"{hi + widen:.5f}]")


def state_warm_starts(system, cfg, states, dev):
    """Each start state of ``states`` ((S, L, n, n) from batch_states)
    advanced two open-loop steps, and its own warm-start command from
    those two steps' coefficients (pipeline.warm_start_command over them,
    as the build's warm start reads its last two identification steps).
    Returns (the (S, L, n, n) states after, the (S, nu) commands)."""
    basis = system.basis
    npix = torch.tensor(float(basis.mask.sum()), dtype=torch.float32,
                        device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(4)
    after, u0 = [], []
    for phases in states.phases:
        st, coeffs = edge_flow.rollout(
            system.edge_model, edge_flow.EdgeFlowState(phases=phases), gen,
            2, basis.fit_full, basis.mask, npix,
            mag=cfg.sim.magnification)
        after.append(st.phases)
        u0.append(pipeline.warm_start_command(
            dataclasses.replace(system, coeff_series=coeffs), cfg, 2))
    return (edge_flow.EdgeFlowState(phases=torch.stack(after)),
            torch.stack(u0))


def build_memory(label: str, fn, card: str):
    """fn() with the card's peak allocation reset before it; prints the
    peak and returns fn's result."""
    torch.cuda.reset_peak_memory_stats()
    result = fn()
    print(f"protocol {label}: peak device allocation "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB [{card}]")
    return result


def protocol_phase(dev, card) -> dict:
    """The port's experiment protocols (benchmarks/protocol_sweep.py,
    protocol_edge.py, excursion_tail.py, modes_horizon.py,
    montecarlo_sweep.py, full_protocol.py, latency_b1.py and the solver
    timers) through B1 on the card, held to the JAX records.  Every run
    is counted (B1's launches exactly as the run's steps ask); returns
    them by run."""
    t_phase = time.time()
    b1 = K.psf_crop_diversity_sym3
    launches, secs, report = {}, {}, {}

    def count(label, fn, want):
        reset_launches()
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        secs[label] = time.perf_counter() - t0
        launches[label] = b1.launches
        if want is not None and b1.launches != want:
            fail(f"protocol {label}: psf_div3_sym launched {b1.launches} "
                 f"times, not {want}")
        return result

    # (a) protocol_sweep: reference rows (one build, D/r0 as a scenario
    # axis) and tuned rows (one build a D/r0), RESULTS_r05.json's split
    cfg = protocol_sweep.base_cfg(PROTO_R, {
        "PROTO_TRAIN": str(PROTO_TRAIN), "PROTO_STEPS": str(PROTO_STEPS)})
    n = cfg.sim.n_test
    start = cfg.sim.n_train + cfg.sim.n_valid
    rec = record("RESULTS_r05.json")
    per_step = 1 + cfg.estimator.gauss_newton_iters
    part, system, _ = count("sweep ref", lambda: build_memory(
        f"sweep reference build R={PROTO_R}", lambda:
        protocol_sweep.reference_rows(cfg, PROTO_D, dev), card),
        per_step * n)
    report["sweep"] = part
    for d in PROTO_D:
        key = f"d_over_r0={d:g}"
        row, want = part["reference_rows"][key], rec["reference_rows"][key]
        print(f"protocol sweep reference {key}: settled exact Strehl "
              f"{row['mean_strehl']} (JAX {want['mean_strehl']}), rejection "
              f"{row['rejection']} (JAX {want['rejection']}), residual "
              f"{row['mean_rms_res_rad']} rad, turbulence "
              f"{row['mean_rms_turb_rad']} rad (JAX "
              f"{want['mean_rms_turb_rad']}), crop valid "
              f"{row.get('strehl_exact_crop_valid', True)} [{card}]")
        if d >= 10.0 and not (row["rejection"] < PROTO_LOCK_REJECTION
                              and row.get("strehl_exact_crop_valid")
                              is False):
            fail(f"protocol sweep reference {key} does not collapse as the "
                 f"JAX row and the float64 oracle do (rejection "
                 f"{row['rejection']})")
    print(f"protocol sweep reference: build {part['reference_build_s']} s, "
          f"loop {part['reference_loop_s']} s, "
          f"{part['reference_solves_per_s']} solves/s, VAR "
          f"{part['reference_var']} (JAX {rec['reference_var']}) [{card}]")
    lo, hi = count("sweep ref seeds d=5", lambda: seed_spread(
        system, cfg, 5.0, None, dev), per_step * n)
    held_in("sweep reference d=5", rec["reference_rows"]["d_over_r0=5"][
        "mean_strehl"], lo, hi, PROTO_WIDEN[5.0], card)
    del system
    tail10 = None
    report["sweep"]["tuned_rows"] = {}
    for d in PROTO_TUNED_D:
        key = f"d_over_r0={d:g}"
        cfg_t, system, build_s = build_memory(
            f"sweep tuned build D/r0={d:g}",
            lambda: protocol_sweep.tuned_build(cfg, d, dev), card)
        secs[f"sweep tuned build d={d:g}"] = build_s
        per_t = 1 + cfg_t.estimator.gauss_newton_iters
        row, out = count(f"sweep tuned d={d:g}", lambda: protocol_sweep
                         .tuned_row(cfg_t, system, build_s, dev), per_t * n)
        report["sweep"]["tuned_rows"][key] = row
        want = rec["tuned_rows"][key]
        print(f"protocol sweep tuned {key}: settled exact Strehl "
              f"{row['mean_strehl']} (min {row['min_strehl']}; JAX "
              f"{want['mean_strehl']}, min {want['min_strehl']}), rejection "
              f"{row['rejection']}, p95 residual {row['p95_rms_res_rad']} "
              f"rad (JAX {want['p95_rms_res_rad']}); C.4 VAR RMSE "
              f"{row['var_rmse_mean']} / RRMSE {row['var_rrmse_mean']} "
              f"(JAX float32 {want['var_rmse_mean']} / "
              f"{want['var_rrmse_mean']}); build {row['build_s']} s, loop "
              f"{row['loop_s']} s [{card}]")
        if not row["finite"] or not row["rejection"] > PROTO_LOCK_REJECTION:
            fail(f"protocol sweep tuned {key}: finite {row['finite']}, "
                 f"rejection {row['rejection']}")
        init_u = pipeline.warm_start_command(system, cfg_t, start)
        lo, hi = count(f"sweep tuned seeds d={d:g}", lambda: seed_spread(
            system, cfg_t, d, init_u, dev), per_t * n)
        held_in(f"sweep tuned {key}", want["mean_strehl"], lo, hi,
                PROTO_WIDEN[d], card)
        if d == PROTO_TAIL_D:
            tail10 = _protocol.tail_row(out)
        del system, out

    # (b) excursion_tail at D/r0=15: the order-10 arm is the tuned d=15
    # row above (the same configuration at the records' split); the
    # clamped order-14 arm runs here
    tails = record("RESULTS_TAIL_r05.json")
    xt0 = excursion_tail.base_cfg(PROTO_R, {
        "XT_TRAIN": str(PROTO_TRAIN), "XT_STEPS": str(PROTO_STEPS)})
    d = PROTO_TAIL_D
    if dataclasses.asdict(xt0) != dataclasses.asdict(cfg):
        fail("protocol: the excursion order-10 arm is not the sweep's tuned "
             "row")
    row14 = count(f"excursion order14_clamp d={d:g}", lambda: build_memory(
        f"excursion order-14 build D/r0={d:g}",
        lambda: excursion_tail.arm_row(xt0, d, 14, 0.85, dev), card),
        n * (1 + xt0.estimator.gauss_newton_iters))
    verdict = excursion_tail.verdict(tail10, row14)
    want = tails[f"d={d:g}_tail_verdict"]
    report["excursion"] = {f"d={d:g}_order10": tail10,
                           f"d={d:g}_order14_clamp": row14,
                           f"d={d:g}_tail_verdict": verdict}
    for arm, row in (("order10", tail10), ("order14_clamp", row14)):
        jrow = tails["rows"][f"d={d:g}_{arm}"]
        print(f"protocol excursion d={d:g} {arm}: mean / min / p5 exact "
              f"Strehl {row['mean_strehl']} / {row['min_strehl']} / "
              f"{row['p5_strehl']} (JAX {jrow['mean_strehl']} / "
              f"{jrow['min_strehl']} / {jrow['p5_strehl']}), p95 residual "
              f"{row['p95_rms_res_rad']} rad, steps under 0.5 "
              f"{row['frac_steps_strehl_below_0.5']} [{card}]")
    print(f"protocol excursion d={d:g} verdict {verdict} (JAX {want}); "
          f"order-14 build {row14['build_s']} s [{card}]")
    jmean = tails["rows"][f"d={d:g}_order14_clamp"]["mean_strehl"]
    if verdict["improved"] != want["improved"] or \
            abs(row14["mean_strehl"] - jmean) > PROTO_TAIL_TOL:
        fail(f"protocol excursion d={d:g}: improved {verdict['improved']} "
             f"(JAX {want['improved']}), order-14 mean Strehl "
             f"{row14['mean_strehl']} (JAX {jmean} +- {PROTO_TAIL_TOL})")

    # (c) protocol_edge stage tuned: rows from the build's state, and the
    # median over PROTO_EDGE_STATES batch_states start states, each from
    # its own warm start
    erec = record("RESULTS_EDGE_r05.json")["tuned_rows"]
    ecfg = protocol_edge.sim_cfg(PROTO_R, PROTO_STEPS, PROTO_TRAIN,
                                 "conditional")
    report["edge"] = {}
    for d in PROTO_EDGE_D:
        key = f"d_over_r0={d:g}"
        cfg_t, system, build_s = build_memory(
            f"edge tuned build D/r0={d:g}",
            lambda: protocol_sweep.tuned_build(ecfg, d, dev), card)
        secs[f"edge tuned build d={d:g}"] = build_s
        per_t = 1 + cfg_t.estimator.gauss_newton_iters
        row, _ = count(f"edge tuned d={d:g}", lambda: protocol_sweep
                       .tuned_row(cfg_t, system, build_s, dev), per_t * n)
        S = PROTO_EDGE_STATES
        tel = dataclasses.replace(cfg_t.telescope, resolution=PROTO_R)
        states, init_u = state_warm_starts(
            system, cfg_t, edge_flow.batch_states(
                int(cfg_t.sim.seed) + 1, cfg_t.atmosphere, tel, S,
                device=dev), dev)
        scen = _protocol.shared_scenarios(
            cfg_t, [cfg_t.sim.magnification] * S, [1.0] * S, 3, dev)
        out = count(f"edge states d={d:g}", lambda: montecarlo.run_batch(
            system.loop, None, cfg_t, scen, n, init_u=init_u,
            edge_model=system.edge_model, edge_state=states), per_t * n)
        del system
        per = out.strehl_exact[:, n // 2:].double().mean(dim=1).cpu()
        med = float(np.median(per.numpy()))
        report["edge"][key] = dict(row, states_strehl=per.tolist(),
                                   states_median=med)
        want = erec[key]["mean_strehl"]
        print(f"protocol edge tuned {key}: from the build's state settled "
              f"exact Strehl {row['mean_strehl']} (rejection "
              f"{row['rejection']}; C.4 VAR {row['var_rmse_mean']} / "
              f"{row['var_rrmse_mean']}, JAX {erec[key]['var_rmse_mean']} / "
              f"{erec[key]['var_rrmse_mean']}); over {S} batch_states "
              f"start states median {med:.5f} (min {float(per.min()):.5f}, "
              f"max {float(per.max()):.5f}); JAX {want}, limit +-"
              f"{PROTO_EDGE_TOL[d]}; build {row['build_s']} s, loop "
              f"{row['loop_s']} s, states run "
              f"{secs[f'edge states d={d:g}']:.2f} s [{card}]")
        if abs(med - want) > PROTO_EDGE_TOL[d]:
            fail(f"protocol edge tuned {key}: median {med:.5f} not within "
                 f"{PROTO_EDGE_TOL[d]} of {want}")

    # (d) modes_horizon, orders 6 and 14: every horizon, B=64, 200 steps
    mrec = record("MODES_r04.json")["cells"]
    base = modes_horizon.base_cfg(MODES_R, MODES_STEPS)
    report["modes"] = {}
    for order in PROTO_MODES_ORDERS:
        cfg_o = modes_horizon.order_cfg(base, order)
        sys_o, secs[f"modes build order={order}"] = build_timed(
            f"protocol modes order={order}", cfg_o, dev)
        gn = cfg_o.estimator.gauss_newton_iters
        m = cfg_o.sim.n_test
        for N in (2, 8, 32):
            for tag, newton_steps in modes_horizon.variants(N):
                c = modes_horizon.cell_cfg(cfg_o, N, newton_steps)
                sys_n = pipeline.with_horizon(sys_o, c)
                key = f"order={order}_N={N}_{tag}"
                # a warm-up and a timed run
                want = ({"solve_fixed": 2 * m} if newton_steps == 1 else
                        {"solve": 2 * m, "banded_solve": 2 * m * newton_steps})
                with count_solver_calls() as calls:
                    row, out = count(f"modes {key}", lambda: modes_horizon
                                     .run_cell(sys_n, c, MODES_BATCH, dev),
                                     2 * m * (1 + gn))
                got = {k: v for k, v in calls.items() if v}
                report["modes"][key] = row
                div = settled(out)["diverged"]
                print(f"protocol modes {key}: settled exact Strehl "
                      f"{row['mean_strehl']} (JAX {mrec[key]['mean_strehl']})"
                      f", rejection {row['rejection']}, {div} diverged, "
                      f"{row['solves_per_s']} solves/s (timed run "
                      f"{row['loop_s']} s), solver calls {got} [{card}]")
                if got != want:
                    fail(f"protocol modes {key}: solver calls {got}, not "
                         f"{want}")
                if N == 32 and (div or not row["finite"] or abs(
                        row["mean_strehl"] - mrec[key]["mean_strehl"])
                        > PROTO_MODES_TOL):
                    fail(f"protocol modes {key} misses its quality target")
        del sys_o, sys_n

    # (e) montecarlo_sweep at D/r0=5: MONTECARLO512_r05.json's d=5 block
    crec = record("MONTECARLO512_r05.json")["cells"]
    cells, dt, _ = count("montecarlo d=5", lambda: montecarlo_sweep.sweep_d(
        PROTO_R, PROTO_MC_D, STRONG_SNRS, STRONG_REPS, n, dev),
        2 * per_step * n)
    report["montecarlo"] = cells
    B = STRONG_REPS * len(STRONG_SNRS)
    for key, cell in cells.items():
        want = crec[key]
        print(f"protocol montecarlo {key}: settled exact Strehl "
              f"{cell['mean_strehl']} (p10 {cell['p10_strehl']}; JAX "
              f"{want['mean_strehl']}), {cell['n_diverged']} diverged "
              f"[{card}]")
        if cell["n_diverged"] or abs(cell["mean_strehl"]
                                     - want["mean_strehl"]) > PROTO_MC_TOL:
            fail(f"protocol montecarlo {key} misses its record")
    print(f"protocol montecarlo d=5: B={B} x {n} steps timed run {dt:.4f} s "
          f"({B * n / dt:.1f} solves/s) [{card}]")

    # (f) full_protocol at its defaults
    res, batch = PROTO_FULL
    fp = count("full_protocol", lambda: full_protocol.main(
        [str(res), str(batch)], {"FP_DEVICE": dev.type}),
        reference_config().sim.n_test * per_step)
    report["full_protocol"] = fp
    want = json.loads(CLASSICAL_REF.read_text())["rows"]["d_over_r0=5"][
        "mpc"]["strehl_exact"]
    print(f"protocol full_protocol R={res} B={batch}: settled exact Strehl "
          f"{fp['mean_strehl_exact']} (JAX, CLASSICAL_r05.json's MPC row of "
          f"this configuration: {want}, limit +-{CLASSICAL_STREHL_TOL}), "
          f"health {fp['health']}, build {fp['build_s']} s, loop "
          f"{fp['loop_s']} s, {fp['solves_per_s']} solves/s [{card}]")
    if abs(fp["mean_strehl_exact"] - want) > CLASSICAL_STREHL_TOL or \
            fp["health"] != "OK":
        fail(f"protocol full_protocol: Strehl {fp['mean_strehl_exact']} "
             f"(JAX {want}), health {fp['health']}")

    # (g) latency_b1 at R=128 and 512
    OUT_DIR.mkdir(exist_ok=True)
    lat = count("latency", lambda: latency_b1.main(
        [str(OUT_DIR / "latency_b1.json")],
        dict(PROTO_LATENCY_ENV, LAT_DEVICE=dev.type)), None)
    report["latency"] = lat
    for key, row in lat["rows"].items():
        print(f"protocol latency {key} B=1: {row['ms_per_step_b1']} ms a step"
              f" by CUDA events (IQR {row['iqr_ms']}), "
              f"{row['host_ms_per_step_b1']} ms by the host clock (IQR "
              f"{row['host_iqr_ms']}), meets 200 Hz {row['meets_200hz']}; "
              f"psf_div3_sym launches a step "
              f"{row.get('b1_launches_per_step')} [{card}]")
        if dev.type == "cuda" and row["b1_launches_per_step"] != 1:
            fail(f"protocol latency {key}: {row['b1_launches_per_step']} B1 "
                 f"launches a step at BENCH_GN=0")

    # (h) the solver timers at their defaults, and card against CPU at B=4
    report["solvers"] = {
        name: module.main(PROTO_TIMER_ARGS[name], {knob: dev.type})
        for name, module, knob in (
            ("solver_throughput", solver_throughput, "ST_DEVICE"),
            ("long_horizon", long_horizon, "LH_DEVICE"),
            ("cholesky_paths", cholesky_paths, "CP_DEVICE"))}
    for name, rows in report["solvers"].items():
        print(f"protocol {name}: " + ", ".join(
            f"{k} {v.get('solves_per_s', v.get('per_s')):,.0f}/s"
            for k, v in rows.items()) + f" [{card}]")
    protocol_solver_check(dev, card)

    report["launches"] = launches
    report["s"] = secs["phase"] = time.time() - t_phase
    (OUT_DIR / "protocol.json").write_text(json.dumps(report, indent=2)
                                           + "\n")
    print("protocol: phase in " + f"{secs['phase']:.2f} s: " + ", ".join(
        f"{k} {v:.2f}" for k, v in secs.items() if k != "phase")
        + f" [{card}]")
    return launches


def protocol_solver_check(dev, card) -> None:
    """The solver timers' solves at B=4 on the card against the CPU
    (tests/test_torch_solvers.py's rtol 1e-4, atol 1e-4 of the scale):
    solver_throughput's two paths, long_horizon's two Schur backends at
    T=32, cholesky_paths' four."""
    cpu = torch.device("cpu")
    B = PROTO_SOLVER_B

    def throughput(d):
        rng = np.random.default_rng(0)
        prob = solver_throughput.problem(rng, 27, d)
        return {k: f() for k, f in solver_throughput.paths(
            prob, 2, *solver_throughput.states(rng, B, 27, 2, d)).items()}

    def horizon(d):
        rng = np.random.default_rng(0)
        prob = solver_throughput.problem(rng, 27, d)
        args = solver_throughput.states(rng, B, 27, 32, d)
        out = {}
        for name, thr in long_horizon.BACKENDS:
            with long_horizon.cr_from(thr):
                out[name] = long_horizon.solve(prob, 32, *args)
        return out

    def chol(d):
        return {k: f() for k, f in cholesky_paths.paths(
            np.random.default_rng(0), B, 27, 2, d).items()}
    for name, fn in (("solver_throughput", throughput),
                     ("long_horizon T=32", horizon),
                     ("cholesky_paths", chol)):
        got, want = fn(dev), fn(cpu)
        for k, w in want.items():
            g = got[k].cpu()
            err = float((g - w).abs().max() / w.abs().max())
            ok = torch.allclose(g, w, rtol=1e-4,
                                atol=1e-4 * float(w.abs().max()))
            print(f"protocol {name} {k} B={B}: card vs CPU max err {err:.3g}"
                  f" of the scale [{card}]")
            if not ok:
                fail(f"protocol {name} {k}: the card's solve disagrees with "
                     f"the CPU's")


def tools_phase(dev, card, strehl_b1: float) -> dict:
    """The port's bench, step and flow timers, scaling report and float64
    oracle rows (benchmarks/bench.py, step_breakdown.py,
    step_knockouts.py, edge_flow_cost.py, edge_flow_breakdown.py,
    scaling.py, oracle_reference_rows.py), each through its main(argv,
    env) on the card, B1 launches counted exactly a run.  The bench at its
    defaults prints one stdout line, reprinted here as "bench: <line>",
    and settles at exact Strehl >= MIN_STREHL, within BENCH_STREHL_TOL of
    ``strehl_b1`` (the slice phase's float32 B1 run: the same
    configuration, build and scenarios).  Returns B1's launches by run."""
    t_phase = time.time()
    b1 = K.psf_crop_diversity_sym3
    gn = reference_config().estimator.gauss_newton_iters
    runs = profiling.TIME_REPEATS + 1      # a warm-up and the timed runs
    launches, secs, report = {}, {}, {}
    OUT_DIR.mkdir(exist_ok=True)

    def count(label, fn, want):
        reset_launches()
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        secs[label] = time.perf_counter() - t0
        launches[label] = b1.launches
        if b1.launches != want:
            fail(f"tools {label}: psf_div3_sym launched {b1.launches} times, "
                 f"not {want}")
        return result

    # (a) the bench at its defaults: a first run and BENCH_REPEATS timed
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        line, meta = count("bench", lambda: bench.main([], {}),
                           STEPS * (1 + BENCH_REPEATS))
    lines = buf.getvalue().splitlines()
    if (len(lines) != 1 or json.loads(lines[0]) != line
            or set(line) != {"metric", "value", "unit", "vs_baseline"}):
        fail(f"tools bench: stdout {lines!r} is not one line of bench.py's "
             f"four keys")
    print(f"bench: {lines[0]}")
    report["bench"] = {"line": line, "meta": meta}
    print(f"tools bench: R={meta['resolution']} B={meta['batch']} "
          f"{meta['steps']} steps, best of {BENCH_REPEATS} runs "
          f"{meta['run_s']} s, first run {meta['compile_s']} s, build "
          f"{meta['build_s']} s; settled exact Strehl "
          f"{meta['mean_strehl']:.5f} (the slice phase's B1 run "
          f"{strehl_b1:.5f}, limit +-{BENCH_STREHL_TOL}, floor {MIN_STREHL}),"
          f" Marechal {meta['mean_strehl_marechal']:.5f}, residual "
          f"{meta['mean_rms_res']:.5f} rad; B1 launches {launches['bench']} "
          f"[{meta['device']}]")
    if not (meta["mean_strehl"] >= MIN_STREHL and abs(
            meta["mean_strehl"] - strehl_b1) <= BENCH_STREHL_TOL):
        fail(f"tools bench: settled exact Strehl {meta['mean_strehl']:.5f} "
             f"(slice B1 run {strehl_b1:.5f})")

    # (b) step_breakdown and step_knockouts at their defaults (R=512, B=256,
    # 25 steps): B1 in the measure stage, in each Gauss-Newton pass and in
    # the whole step; in every knockout variant, once a pass
    sb = count("step_breakdown", lambda: step_breakdown.main([], {}),
               runs * STEPS * (2 + 2 * gn))
    report["step_breakdown"] = sb
    print(f"tools step_breakdown R={sb['R']} B={sb['B']} {sb['steps']} "
          f"steps, us a step a scenario: " + ", ".join(
              f"{k[:-3]} {v}" for k, v in sb.items() if k.endswith("_us"))
          + f" [{card}]")
    ko = count("step_knockouts", lambda: step_knockouts.main([], {}),
               runs * STEPS * sum(1 + kw.get("gn", gn) for kw in
                                  step_knockouts.VARIANTS.values()))
    report["step_knockouts"] = ko
    print(f"tools step_knockouts R={ko['R']} B={ko['B']} {ko['steps']} "
          f"steps, us a step a scenario: " + ", ".join(
              f"{k[:-3]} {v}" for k, v in ko.items() if k.endswith("_us"))
          + f"; full / step_breakdown's full step "
          f"{ko['full_us'] / sb['full_step_us']:.3f} [{card}]")
    if set(ko) != {"R", "B", "steps", "device"} | {
            f"{k}_us" for k in step_knockouts.VARIANTS}:
        fail(f"tools step_knockouts: keys {sorted(ko)}")

    # (c) edge_flow_cost at R=128: both flows, TOOLS_EFC_STEPS steps, 1 + 3
    # runs each
    efc = count("edge_flow_cost", lambda: edge_flow_cost.main(
        [str(TOOLS_EDGE_R), str(TOOLS_EFC_STEPS)], {}),
        len(edge_flow_cost.FLOWS) * 4 * TOOLS_EFC_STEPS * (1 + gn))
    report["edge_flow_cost"] = efc
    for flow in edge_flow_cost.FLOWS:
        r = efc[flow]
        print(f"tools edge_flow_cost R={efc['resolution']} {flow}: "
              f"{r['us_per_step']} us a step (best of 3 {r['loop_s']} s), "
              f"settled exact Strehl {r['mean_strehl']} [{card}]")
        if not r["mean_strehl"] >= LOCK_STREHL:
            fail(f"tools edge_flow_cost {flow}: settled exact Strehl "
                 f"{r['mean_strehl']}")
    print(f"tools edge_flow_cost: conditional overhead "
          f"{efc['conditional_overhead_us_per_step']} us a step [{card}]")

    # (d) edge_flow_breakdown at R=128: its rows, then the closed loop at
    # B=1 and 64 (a warm-up, the event-timed and the host-timed runs)
    out = OUT_DIR / "edge_flow_breakdown.json"
    out.unlink(missing_ok=True)
    efb = count("edge_flow_breakdown", lambda: edge_flow_breakdown.main(
        [str(out)], {"EFB_RES": str(TOOLS_EDGE_R),
                     "EFB_REPEATS": str(TOOLS_EFB_REPEATS)}),
        4 * (1 + 2 * TOOLS_EFB_REPEATS)
        * edge_flow_breakdown.STEPS * (1 + gn))
    report["edge_flow_breakdown"] = efb
    print(f"tools edge_flow_breakdown R={efb['resolution']}, us a step "
          f"(median, IQR): " + ", ".join(
              f"{k} {v['us_per_step']} {v['iqr_us']}"
              for k, v in efb["advance_breakdown"].items()) + f" [{card}]")
    for b, row in efb["closed_loop"].items():
        print(f"tools edge_flow_breakdown {b}: " + ", ".join(
            f"{f} {row[f]['us_per_step']} us a step by events (IQR "
            f"{row[f]['iqr_us']}), {row[f]['host_us_per_step']} by the host "
            f"clock" for f in ("periodic", "conditional"))
            + f"; conditional overhead "
            f"{row['conditional_overhead_us_per_step']} us [{card}]")
    print(f"tools edge_flow_breakdown: not ported "
          f"{sorted(efb['not_ported'])}")

    # (e) scaling: worlds of 1 and 2 gloo ranks sharing cuda:0
    sc = count("scaling", lambda: scaling.main(
        ["8", "20", str(OUT_DIR / "scaling.json")], SCALING_ENV), 0)
    report["scaling"] = sc
    want = {str(k): [20 * (1 + gn)] * k for k in (1, 2)}
    launches["scaling ranks"] = sum(sum(v) for v in sc["b1_launches"].values())
    print(f"tools scaling (gloo ranks on cuda:0, cross_card "
          f"{sc['cross_card']}): solves/s {sc['solves_per_s']}, efficiency "
          f"{sc['efficiency']}; B1 launches a rank {sc['b1_launches']} "
          f"[{card}]")
    if sc["b1_launches"] != want or sc["cross_card"]:
        fail(f"tools scaling: B1 launches {sc['b1_launches']}, not {want}; "
             f"cross_card {sc['cross_card']}")

    # (f) the float64 oracle rows on the card's build, cut to R=64 and 20
    # steps (the R=512 rows of ORACLE_REFROWS_r04.json take minutes of
    # host time: run the script itself for them)
    orr = count("oracle", lambda: oracle_reference_rows.main(
        [str(OUT_DIR / "oracle_r64.json")], ORACLE_ENV), 0)
    report["oracle"] = orr
    for key, row in orr["rows"].items():
        print(f"tools oracle R={orr['resolution']} {orr['n_steps']} steps "
              f"{key}: residual {row['mean_rms_res_rad']} rad, turbulence "
              f"{row['mean_rms_turb_rad']} rad, rejection {row['rejection']},"
              f" collapsed {row['collapsed']} (oracle {row['oracle_s']} s)")
        if not np.isfinite(row["mean_rms_res_rad"]) or (
                key.startswith("d_over_r0=5_") and row["collapsed"]):
            fail(f"tools oracle {key}: {row}")

    # (g) the whole step (run_batch) against the knockouts' replica of it
    # (telemetry "stacked": simulate's StepOutputs) at R=512, B=256, in
    # turns, then each traced; the conditional flow's advance against its
    # integer-lattice part (no_frac) at R=128, traced
    cfg5 = step_breakdown.step_cfg(512, STEPS)
    sys5 = pipeline.build(cfg5, dev)
    B5 = 256
    scen5 = montecarlo.make_scenarios(cfg5, torch.Generator().manual_seed(1),
                                      B5, device=dev)
    pair = {
        "run_batch": lambda: montecarlo.run_batch(
            sys5.loop, sys5.layers, cfg5, scen5, STEPS,
            shared_window="verified"),
        "replica": lambda: step_knockouts.run_variant(
            sys5.loop, sys5.layers, cfg5, scen5.mag, scen5.noise_scale,
            STEPS, cfg5.sim.n_train + cfg5.sim.n_valid,
            _protocol.generator(dev, 7), telemetry="stacked"),
    }

    def turns():
        got = {k: [] for k in pair}
        for k in ("run_batch", "replica", "replica", "run_batch"):
            got[k].append(round(step_breakdown.us_per_step(
                pair[k], dev, STEPS, B5), 2))
        for k, fn in pair.items():
            trace_window(f"tools {k} R=512 B={B5}", fn, card, f"tools_{k}")
        return got
    got = count("step trace", turns, 28 * STEPS * (1 + gn))
    report["step_turns_us"] = got
    print(f"tools whole step vs replica R=512 B={B5}, us a step a scenario "
          f"in turns (each the median of {profiling.TIME_REPEATS} runs): "
          f"{got} [{card}]")
    tel = dataclasses.replace(cfg5.telescope, resolution=TOOLS_EDGE_R)
    model, state0 = edge_flow.build(0, cfg5.atmosphere, tel, device=dev)
    for name, step in edge_flow_breakdown.breakdown_steps(
            model, model, _protocol.generator(dev, 3)).items():
        if name not in ("no_frac", "full_new"):
            continue

        def advance_run(step=step):
            phases = state0.phases[None]
            for idx in range(STEPS):
                phases, _ = step(phases, idx)
        count(f"flow trace {name}", lambda: trace_window(
            f"tools advance {name} R={TOOLS_EDGE_R}", advance_run, card,
            f"tools_{name}"), 0)

    report["launches"] = launches
    report["s"] = secs["phase"] = time.time() - t_phase
    (OUT_DIR / "tools.json").write_text(json.dumps(report, indent=2) + "\n")
    print("tools: phase in " + f"{secs['phase']:.2f} s: " + ", ".join(
        f"{k} {v:.2f}" for k, v in secs.items() if k != "phase")
        + f" [{card}]")
    return launches


def modes_cfg():
    """MODES_r04.json's order-10 N=32 configuration, from the port's
    benchmarks/modes_horizon.py: reference_config(128), radial order 10
    (66 modes, 65 states), the tuned recipe at D/r0=5 (mmse prior scale
    0.1) with var_max_radius 0.85, the sim defaults (n_train 1000, n_valid
    500), 200 steps, horizon 32."""
    return modes_horizon.cell_cfg(modes_horizon.order_cfg(
        modes_horizon.base_cfg(MODES_R, MODES_STEPS), 10), 32, 1)


def main() -> None:
    t_start = time.time()
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
    t0 = time.time()
    system_bf16 = pipeline.build(slice_cfg(BF16), dev)
    torch.cuda.synchronize()
    print(f"slice: pipeline.build with dft_dtype={BF16} in "
          f"{time.time() - t0:.2f} s")
    if system_bf16.est.dft_dtype != BF16:
        fail(f"the bf16 build's estimator has dft_dtype "
             f"{system_bf16.est.dft_dtype}")
    loop_launches, run_s, fixed = slice_phase(system, system_bf16, cfg, dev,
                                              card)
    trace_phase(system, cfg, run_s["sym3"], card)
    cfg_wide = slice_cfg(crop_half=WIDE_CROP_HALF)
    t0 = time.time()
    system_wide = pipeline.build(cfg_wide, dev)
    torch.cuda.synchronize()
    print(f"wide: pipeline.build with crop_half={WIDE_CROP_HALF} in "
          f"{time.time() - t0:.2f} s")
    wide_phase(system, system_wide, cfg, cfg_wide, dev, card)
    loop_512_phase(dev, card)
    strong_launches = strong_phase(dev, card)
    solver_launches = solvers_phase(system, cfg, fixed, dev, card)
    edge_launches = edge_phase(dev, card)
    parallel_launches = parallel_phase(system, cfg, dev, card)
    population_launches = population_phase(card)
    classical_launches = classical_phase(dev, card)
    reset_launches()
    a12_phase(dev, card)
    for name, wrapper, *_ in KERNELS + CHAINS:
        if wrapper.launches:
            fail(f"a12: the slice launched {name} {wrapper.launches} times; "
                 f"it runs no PSF kernel")
    protocol_launches = protocol_phase(dev, card)
    tools_launches = tools_phase(dev, card, fixed["strehl"])
    report, chain_launches, chain_line = peaks_phase(card)
    roofline_phase(system, cfg, report["peaks"], times, card)
    kernels = []
    for lib, _, _, replaces, variant, route in KERNELS:
        ms, plain_ms = times[variant]
        b = roofline.measure_bound(variant, 128, BATCH)
        if lib == "psf_div3_sym":
            paths = {f"launches_{k}": v for k, v in strong_launches.items()}
            paths.update({f"launches_solvers {k}": v
                          for k, v in solver_launches.items()})
            paths.update({f"launches_edge {k}": v
                          for k, v in edge_launches.items()})
            paths.update({f"launches_parallel {k}": v
                          for k, v in parallel_launches.items()})
            paths.update({f"launches_population {k}": v
                          for k, v in population_launches.items()})
            paths.update({f"launches_classical {k}": v
                          for k, v in classical_launches.items()})
            paths.update({f"launches_protocol {k}": v
                          for k, v in protocol_launches.items()})
            paths.update({f"launches_tools {k}": v
                          for k, v in tools_launches.items()})
        else:
            paths = {}
        kernels.append({**paths,
            "name": lib, "route": "cuda", "source": f"{CSRC}/{lib}.cu",
            "replaces": replaces,
            "launches": (loop_launches[lib] if route
                         else variant_launches[lib]),
            "max_abs_err": max_err[lib], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b["bound_ms"], "bound_by": b["bound_by"],
            "fp32_bound_ms": b["fp32_bound_ms"], "library_ms": None})
    for name, lib, _, _, replaces, variant, route in BF16_KERNELS:
        ms, plain_ms = times[variant]
        b = roofline.measure_bound(kernel_variants.precision(variant)[0],
                                   128, BATCH, compute_dtype=BF16)
        kernels.append({
            "name": name, "route": "cuda", "source": f"{CSRC}/{lib}.cu",
            "replaces": replaces,
            "launches": (loop_launches[name] if route
                         else variant_launches[name]),
            "max_abs_err": max_err[name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b["bound_ms"], "bound_by": b["bound_by"],
            "fp32_bound_ms": b["fp32_bound_ms"], "library_ms": None})
    for lib, _, _, replaces in CHAINS:
        kernels.append({
            "name": lib, "route": "cuda", "source": f"{CSRC}/{lib}.cu",
            "replaces": replaces, "launches": chain_launches[lib],
            "max_abs_err": max_err[lib], **chain_line[lib]})
    print(json.dumps({"kernels": kernels}))
    print(f"smoke: {time.time() - t_start:.2f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
