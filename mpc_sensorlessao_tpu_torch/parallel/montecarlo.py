"""Monte-Carlo closed-loop scenario batches on one device (port of the
single-device part of ``mpc_sensorlessao_tpu/parallel/montecarlo.py``).

Scenarios vary turbulence window, D/r0 and SNR; the closed loop runs them
as one batch.  The sharded multi-device runner is not ported yet
(ROADMAP.md A.10).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..models import closed_loop
from ..utils.config import SystemConfig, mag_conv


class ScenarioBatch(NamedTuple):
    """Per-scenario parameters (leading dim = scenario).

    start_step:  (B,) float32 window offset into the periodic screens;
    mag:         (B,) float32 turbulence magnification (D/r0 sweep,
                 README.md:277-284);
    noise_scale: (B,) float32 multiplier on the SNR-defined noise std;
    noise_seed:  seed of the batch's measurement-noise generator.
    """

    start_step: torch.Tensor
    mag: torch.Tensor
    noise_scale: torch.Tensor
    noise_seed: int


def make_scenarios(cfg: SystemConfig, generator: torch.Generator,
                   n_scenarios: int, d_over_r0_grid=(5.0,),
                   snr_db_grid=(10.0,), start_range=None,
                   device: torch.device | str = "cuda") -> ScenarioBatch:
    """Sample a scenario batch over (noise, D/r0, SNR[, window]) with a
    CPU ``generator``; tensors land on ``device``.

    By default every scenario cold-starts at the test-split step like the
    reference loop (README.md:429-444); ``start_range=(lo, hi)`` draws
    per-scenario windows.
    """
    B = n_scenarios
    if start_range is None:
        start = torch.full((B,), float(cfg.sim.n_train + cfg.sim.n_valid))
    else:
        lo, hi = start_range
        start = torch.randint(lo, max(hi, lo + 1), (B,),
                              generator=generator).float()
    mags = torch.tensor([mag_conv(d) for d in d_over_r0_grid],
                        dtype=torch.float32)
    mag = mags[torch.randint(0, len(mags), (B,), generator=generator)]
    # noise_scale = 10^((SNR_cfg - SNR_scenario)/20)
    scales = torch.tensor(
        [10.0 ** ((cfg.estimator.snr_db - s) / 20.0) for s in snr_db_grid],
        dtype=torch.float32)
    noise_scale = scales[torch.randint(0, len(scales), (B,),
                                       generator=generator)]
    seed = int(torch.randint(0, 2 ** 62, (1,), generator=generator))
    return ScenarioBatch(start_step=start.to(device), mag=mag.to(device),
                         noise_scale=noise_scale.to(device), noise_seed=seed)


def assert_shared_window(scen: ScenarioBatch) -> None:
    """Check that every scenario shares one turbulence window."""
    starts = scen.start_step.cpu()
    if not bool((starts == starts[0]).all()):
        raise ValueError(
            "scenarios have distinct start_steps; use the batched path")


def run_batch(models: closed_loop.LoopModels, layers, cfg: SystemConfig,
              scen: ScenarioBatch, n_steps: int, solver: str | None = None,
              shared_window: bool | str = False,
              init_u: torch.Tensor | None = None) -> closed_loop.StepOutputs:
    """The closed loop over the scenario batch; outputs (B, T, ...).

    ``shared_window`` (True or "verified") runs the shared-window fast
    path: the frozen-flow sample and its piston removal are computed once
    per step and broadcast, instead of gathered per scenario.  The window
    is checked on the concrete batch either way (assert_shared_window);
    trajectories equal those of the batched path.  Noise comes from a
    generator on the models' device seeded with ``scen.noise_seed``.
    ``init_u`` ((nu,) or (B, nu)) is the warm-start command
    (MPCConfig.warm_start; pipeline.warm_start_command), applied on both
    paths.
    """
    gen = torch.Generator(device=models.influence.device)
    gen.manual_seed(scen.noise_seed)
    if shared_window:
        assert_shared_window(scen)
        start = float(scen.start_step[0])
    else:
        start = scen.start_step
    return closed_loop.simulate(models, layers, cfg, gen, n_steps=n_steps,
                                start_step=start, solver=solver,
                                mag=scen.mag, noise_scale=scen.noise_scale,
                                init_u=init_u)
