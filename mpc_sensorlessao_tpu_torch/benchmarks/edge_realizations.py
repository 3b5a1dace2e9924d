"""Realizations of the conditional-Gaussian flow on one CUDA card: does the
28-mode LS loop's lock at D/r0 >= 10 depend on the start state?

    python -m mpc_sensorlessao_tpu_torch.benchmarks.edge_realizations [out.json]
    python -m mpc_sensorlessao_tpu_torch.benchmarks.edge_realizations screens

Builds reference_config(512) on ``flow="conditional"`` with the JAX
protocol's n_train 1000 and n_valid 50 (benchmarks/protocol_edge.py) on
CUDA device 0 and reports, beside the card's name and power limit:

  build_state    each layer's structure function at the test split over
                 its Von Karman value at 16, 64 and 256 px;
  evolution      the mean and spread of that ratio over 20 states, 40
                 steps apart, of an 800-step evolution from there;
  noise_streams  the reference rows (D/r0 5/10/15/20, one realization
                 shared over the grid, 500 steps, settled exact Strehl
                 and turbulence RMS over the second half) from the
                 build's state under 10 border-noise streams;
  start_states   the same rows, 300 steps, from 8 other start states
                 (the build's state advanced 60 steps, 770-1500 px of
                 wind, under a stream of its own).

Prints one JSON report and writes it to ``out.json`` when a path is
given.  ``screens`` instead times the host synthesis of 24 initial
screens at 512 px in edge_flow.SCREEN_THREADS threads and in one.
Raises without a CUDA device.
"""

from __future__ import annotations

import dataclasses
import json
import sys
import time

import numpy as np
import torch

from .. import reference_config
from ..models import pipeline
from ..ops import edge_flow, phase_screens, phase_stats
from ..parallel import montecarlo
from ..utils import profiling
from ..utils.config import mag_conv

RESOLUTION = 512
D_GRID = (5.0, 10.0, 15.0, 20.0)
SEPARATIONS = (16, 64, 256)
NOISE_STREAMS = 10
START_STATES = 8
ROW_STEPS = 500
START_ROW_STEPS = 300
START_ADVANCE = 60
EVOLUTION = (800, 40)       # steps, and the steps between sampled states


def edge_cfg(resolution: int = RESOLUTION):
    cfg = reference_config(resolution=resolution)
    return cfg.replace(
        atmosphere=dataclasses.replace(cfg.atmosphere, flow="conditional"),
        sim=dataclasses.replace(cfg.sim, n_train=1000, n_valid=50))


def structure_ratios(cfg, phases: torch.Tensor) -> list:
    """Per layer, the empirical structure function of an (L, n, n) state
    (rows and columns) over the Von Karman value, at SEPARATIONS px."""
    ph = phases.double().cpu().numpy()
    pitch = cfg.telescope.diameter / (cfg.resolution - 1)
    out = []
    for i, layer in enumerate(ph):
        row = []
        for sep in SEPARATIONS:
            emp = 0.5 * (np.mean((layer[:, sep:] - layer[:, :-sep]) ** 2)
                         + np.mean((layer[sep:] - layer[:-sep]) ** 2))
            row.append(float(emp / phase_stats.structure_function(
                sep * pitch, cfg.atmosphere.layer(i), np)))
        out.append(row)
    return out


def rows(system, cfg, state, start: float, n_steps: int,
         generator: torch.Generator) -> dict:
    """The reference rows from ``state``: one realization shared over
    D_GRID, settled (second-half) exact Strehl and turbulence RMS."""
    dev = system.loop.influence.device
    f32 = dict(dtype=torch.float32, device=dev)
    B = len(D_GRID)
    scen = montecarlo.ScenarioBatch(
        start_step=torch.full((B,), start, **f32),
        mag=torch.tensor([mag_conv(d) for d in D_GRID], **f32),
        noise_scale=torch.ones((B,), **f32), noise_seed=1)
    out = montecarlo.run_batch(system.loop, None, cfg, scen, n_steps,
                               edge_model=system.edge_model,
                               edge_state=state, shared_turbulence=True,
                               turb_generator=generator)
    s = n_steps // 2
    return {"strehl": out.strehl_exact[:, s:].double().mean(dim=1).tolist(),
            "turbulence_rms": out.rms_turb[:, s:].double().mean(dim=1)
            .tolist()}


def generator(seed: int, dev) -> torch.Generator:
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return gen


def measure(dev, resolution: int = RESOLUTION) -> dict:
    cfg = edge_cfg(resolution)
    t0 = time.time()
    system = pipeline.build(cfg, dev)
    report = {"build_s": time.time() - t0, "d_over_r0": list(D_GRID),
              "separations_px": list(SEPARATIONS),
              "build_state": structure_ratios(cfg, system.edge_state.phases)}
    model, start = system.edge_model, cfg.sim.n_train + cfg.sim.n_valid
    steps, every = EVOLUTION
    gen, state, ratios = generator(100, dev), system.edge_state, []
    for i in range(steps):
        state, _ = edge_flow.advance(model, state, start + i, gen)
        if (i + 1) % every == 0:
            ratios.append(structure_ratios(cfg, state.phases))
    report["evolution"] = {"mean": np.mean(ratios, axis=0).tolist(),
                           "std": np.std(ratios, axis=0).tolist()}
    report["noise_streams"] = [
        rows(system, cfg, system.edge_state, float(start), ROW_STEPS,
             generator(seed, dev)) for seed in range(NOISE_STREAMS)]
    report["start_states"] = []
    for k in range(START_STATES):
        gen, state = generator(1000 + k, dev), system.edge_state
        for i in range(START_ADVANCE):
            state, _ = edge_flow.advance(model, state, start + i, gen)
        row = rows(system, cfg, state, float(start + START_ADVANCE),
                   START_ROW_STEPS, gen)
        row["structure_ratios_256px"] = [
            r[-1] for r in structure_ratios(cfg, state.phases)]
        report["start_states"].append(row)
    return report


def screens(threads: int, n_sets: int = 8) -> float:
    """Seconds to synthesize n_sets x L initial screens at RESOLUTION px
    in ``threads`` host threads (screens at once, and bands of a screen's
    subharmonics)."""
    cfg = edge_cfg()
    saved = edge_flow.SCREEN_THREADS, phase_screens.SCREEN_THREADS
    edge_flow.SCREEN_THREADS = phase_screens.SCREEN_THREADS = threads
    try:
        t0 = time.time()
        edge_flow._initial_phases(list(range(n_sets)), cfg.atmosphere,
                                  RESOLUTION, cfg.telescope.diameter
                                  / (RESOLUTION - 1))
        return time.time() - t0
    finally:
        edge_flow.SCREEN_THREADS, phase_screens.SCREEN_THREADS = saved


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("edge_realizations needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = profiling.card()
    if sys.argv[1:] == ["screens"]:
        threads = edge_flow.SCREEN_THREADS
        report = {f"{threads}_threads_s": screens(threads),
                  "1_thread_s": screens(1)}
    else:
        report = measure(torch.device("cuda:0"))
    report.update(card=card, device=torch.cuda.get_device_name(0))
    print(json.dumps(report))
    if sys.argv[1:] and sys.argv[1] != "screens":
        with open(sys.argv[1], "w") as f:
            json.dump(report, f, indent=1)


if __name__ == "__main__":
    main()
