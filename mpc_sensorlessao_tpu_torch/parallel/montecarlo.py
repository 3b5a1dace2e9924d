"""Monte-Carlo closed-loop scenario batches on one device (port of the
single-device part of ``mpc_sensorlessao_tpu/parallel/montecarlo.py``).

Scenarios vary turbulence window (or conditional-flow realization), D/r0
and SNR; the closed loop runs them as one batch.  The sharded
multi-device runner is not ported yet (ROADMAP.md A.10).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..models import closed_loop
from ..utils.config import SystemConfig, mag_conv

# mixed into the default border-noise seed of run_batch's conditional flow
TURB_SEED_SALT = 0x7E5


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
              init_u: torch.Tensor | None = None,
              edge_model=None, edge_state=None,
              shared_turbulence: bool | str = False,
              turb_generator: torch.Generator | None = None,
              ) -> closed_loop.StepOutputs:
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

    ``edge_model``/``edge_state`` switch the turbulence to the
    conditional-Gaussian flow (ops/edge_flow.py), in two modes:

    * ``shared_turbulence`` (True or "verified") -- ONE realization
      shared by every scenario, advanced once a step and broadcast (the
      analogue of ``shared_window``): it needs a shared start step
      (checked as ``shared_window`` is) and an unbatched (L, n, n)
      state;
    * default -- per-scenario turbulence: each scenario draws its own
      border noise from the scenario's start step (distinct start steps
      allowed), from a (B, L, n, n) state (edge_flow.batch_states) or an
      unbatched one that every scenario starts from.

    ``turb_generator`` draws the border noise (on the models' device);
    by default it is seeded from cfg.sim.seed for shared turbulence and
    from ``scen.noise_seed`` per scenario.
    """
    dev = models.influence.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(scen.noise_seed)
    kw = {}
    if edge_model is not None:
        if shared_turbulence and edge_state.phases.dim() != 3:
            raise ValueError(
                "shared_turbulence needs ONE unbatched edge_state")
        if turb_generator is None:
            turb_generator = torch.Generator(device=dev)
            turb_generator.manual_seed(
                (int(cfg.sim.seed) if shared_turbulence else scen.noise_seed)
                ^ TURB_SEED_SALT)
        kw = dict(edge_model=edge_model, edge_state=edge_state,
                  turb_generator=turb_generator)
        shared_window = shared_turbulence
    if shared_window:
        assert_shared_window(scen)
        start = float(scen.start_step[0])
    else:
        start = scen.start_step
    return closed_loop.simulate(models, layers, cfg, gen, n_steps=n_steps,
                                start_step=start, solver=solver,
                                mag=scen.mag, noise_scale=scen.noise_scale,
                                init_u=init_u, **kw)
