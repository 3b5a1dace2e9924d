"""Monte-Carlo closed-loop scenario batches (port of
``mpc_sensorlessao_tpu/parallel/montecarlo.py``).

Scenarios vary turbulence window (or conditional-flow realization), D/r0
and SNR; the closed loop runs them as one batch on one device
(``run_batch``), or scenario-sharded over the ranks of a
``torch.distributed`` world (``make_sharded_runner``, ``run_sharded``):
each rank runs its contiguous rows of the global batch and the
statistics are reduced with one ``all_reduce(SUM)`` and one
``all_reduce(MAX)`` over the mesh's group -- NCCL between cards, gloo
between CPU ranks.
"""

from __future__ import annotations

import itertools
from typing import NamedTuple

import torch
import torch.distributed as dist

from ..models import closed_loop
from ..utils import profiling
from ..utils.config import SystemConfig, mag_conv
from . import multihost

# mixed into the default border-noise seed of run_batch's conditional flow
TURB_SEED_SALT = 0x7E5
# the episode ids of run_batch's spans
_EPISODES = itertools.count()


class MonteCarloStats(NamedTuple):
    """Statistics reduced over every scenario, 0-d float64 tensors on the
    runner's device.

    Divergence containment: a scenario whose settled telemetry is
    non-finite or whose settled residual exceeds
    ``DIVERGED_REJECTION_FLOOR`` x its own turbulence is counted in
    ``n_diverged`` and left out of the means and the maximum, so one
    blown-up scenario cannot turn a whole reduction to NaN."""

    mean_rms_res: torch.Tensor     # settled mean residual RMS [rad]
    mean_rms_turb: torch.Tensor
    mean_strehl: torch.Tensor      # Marechal
    mean_strehl_exact: torch.Tensor  # OTF-volume (imager.m:115)
    max_rms_res: torch.Tensor      # over settled steps of kept scenarios
    mean_cost: torch.Tensor
    n_scenarios: torch.Tensor      # kept (not diverged)
    n_diverged: torch.Tensor

    def as_floats(self) -> dict:
        """The statistics as host floats, by name."""
        return {k: float(v) for k, v in self._asdict().items()}


# a "settled" loop whose residual exceeds this multiple of the raw
# turbulence is injecting aberration, not correcting it
DIVERGED_REJECTION_FLOOR = 10.0


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


def _settled_slice(n_steps: int) -> int:
    return max(n_steps // 2, 1)


def assert_shared_window(scen: ScenarioBatch) -> None:
    """Check that every scenario shares one turbulence window."""
    starts = scen.start_step.cpu()
    if not bool((starts == starts[0]).all()):
        raise ValueError(
            "scenarios have distinct start_steps; use the batched path")


def run_batch(models: closed_loop.LoopModels, layers, cfg: SystemConfig,
              scen: ScenarioBatch, n_steps: int, solver: str | None = None,
              shared_window: bool = False,
              init_u: torch.Tensor | None = None,
              edge_model=None, edge_state=None,
              shared_turbulence: bool = False,
              turb_generator: torch.Generator | None = None,
              rows: slice | None = None) -> closed_loop.StepOutputs:
    """The closed loop over the scenario batch; outputs (B, T, ...).

    ``shared_window`` runs the periodic screens' shared window (checked:
    assert_shared_window): the screen sample and its piston removal run
    once a step, broadcast; the trajectories are the per-scenario
    windows' up to float32 roundoff.  Noise comes from a generator on the
    models' device seeded with ``scen.noise_seed``.  ``init_u`` is the
    warm-start command (pipeline.warm_start_command), (nu,) or (B, nu).

    ``edge_model``/``edge_state`` switch the turbulence to the
    conditional-Gaussian flow (ops/edge_flow.py), where
    ``shared_turbulence`` takes the place of ``shared_window``: ONE
    realization from an unbatched (L, n, n) state, advanced once a step
    and broadcast.  By default each scenario draws its own border noise
    from its own start step, from a (B, L, n, n) state
    (edge_flow.batch_states) or an unbatched one they all start from.
    ``turb_generator`` draws the border noise (on the models' device),
    by default seeded from cfg.sim.seed for shared turbulence and from
    ``scen.noise_seed`` per scenario.

    ``rows`` runs only those rows of the batch, every random draw still
    the whole batch's (closed_loop.simulate(rows=...)): a scenario's
    trajectory is the same whichever rows run beside it.
    """
    with profiling.span("loop.episode", episode=next(_EPISODES)):
        dev = models.influence.device
        gen = torch.Generator(device=dev)
        gen.manual_seed(scen.noise_seed)
        kw, shared = {}, bool(shared_window)
        if edge_model is not None:
            shared = bool(shared_turbulence)
            if shared and edge_state.phases.dim() != 3:
                raise ValueError(
                    "shared_turbulence needs ONE unbatched edge_state")
            if turb_generator is None:
                turb_generator = torch.Generator(device=dev)
                turb_generator.manual_seed(
                    (int(cfg.sim.seed) if shared else scen.noise_seed)
                    ^ TURB_SEED_SALT)
            kw = dict(edge_model=edge_model, edge_state=edge_state,
                      turb_generator=turb_generator)
        if shared:
            assert_shared_window(scen)
        return closed_loop.simulate(
            models, layers, cfg, gen, n_steps=n_steps,
            start_step=float(scen.start_step[0]) if shared
            else scen.start_step, solver=solver, mag=scen.mag,
            noise_scale=scen.noise_scale, init_u=init_u, rows=rows, **kw)


def _local_sums(out: closed_loop.StepOutputs, n_steps: int):
    """(sums, max) of one batch's telemetry with per-scenario divergence
    containment: sums (7,) float64 of the kept scenarios' settled means
    of (rms_res, rms_turb, strehl, strehl_exact, cost) and the kept and
    diverged counts; max the largest settled residual of a kept
    scenario (0 if none)."""
    settle = _settled_slice(n_steps)
    res = out.rms_res[:, settle:].double()
    res_m = res.mean(dim=1)
    turb_m = out.rms_turb[:, settle:].double().mean(dim=1)
    finite = torch.isfinite(res_m) & torch.isfinite(turb_m)
    ok = finite & (torch.nan_to_num(res_m, nan=torch.inf)
                   <= DIVERGED_REJECTION_FLOOR
                   * torch.nan_to_num(turb_m, nan=0.0))
    okf = ok.double()

    def safe_sum(x_m):
        return torch.where(ok, torch.nan_to_num(x_m), 0.0).sum()

    sums = torch.stack([
        safe_sum(res_m), safe_sum(turb_m),
        safe_sum(out.strehl[:, settle:].double().mean(dim=1)),
        safe_sum(out.strehl_exact[:, settle:].double().mean(dim=1)),
        safe_sum(out.cost[:, settle:].double().mean(dim=1)),
        okf.sum(), (1.0 - okf).sum()])
    mx = torch.where(ok[:, None], torch.nan_to_num(res), 0.0).amax()
    return sums, mx


def _finish(sums: torch.Tensor, mx: torch.Tensor) -> MonteCarloStats:
    n = torch.clamp(sums[5], min=1.0)
    return MonteCarloStats(
        mean_rms_res=sums[0] / n, mean_rms_turb=sums[1] / n,
        mean_strehl=sums[2] / n, mean_strehl_exact=sums[3] / n,
        max_rms_res=mx, mean_cost=sums[4] / n, n_scenarios=sums[5],
        n_diverged=sums[6])


def reduce_stats(out: closed_loop.StepOutputs,
                 n_steps: int) -> MonteCarloStats:
    """The sharded runner's statistics of one process's (B, T) telemetry:
    the same reduction, without a collective."""
    return _finish(*_local_sums(out, n_steps))


def make_sharded_runner(models: closed_loop.LoopModels, layers,
                        cfg: SystemConfig, n_steps: int, mesh,
                        solver: str | None = None,
                        shared_window: bool = False,
                        edge_model=None, edge_state=None,
                        shared_turbulence: bool = False,
                        turb_generator: torch.Generator | None = None):
    """The scenario-sharded Monte-Carlo runner over a 1-D DeviceMesh
    (mesh.scenario_mesh): ``run(scen) -> MonteCarloStats``, called by
    every rank with the same global ScenarioBatch, its size a multiple of
    the mesh size (mesh.pad_to_devices).  Each rank runs its contiguous
    rows (multihost.scenario_rows) through ``run_batch``, whose draws are
    the whole batch's, so the statistics equal ``reduce_stats`` of
    ``run_batch`` over the global batch on one device up to float
    rounding.  The models live on each rank's device; eight numbers a
    run cross ranks, one ``all_reduce(SUM)`` of the sums and counts and
    one ``all_reduce(MAX)`` over the mesh's group; means divide by the
    global count of kept scenarios.

    ``edge_model``/``edge_state`` run the conditional flow on every rank
    from one unbatched state; ``shared_turbulence`` shares one
    realization over the global batch, its border noise from
    ``turb_generator`` (default seeded from cfg.sim.seed), which every
    call restarts from its state at build time.
    """
    if edge_state is not None and edge_state.phases.dim() == 4:
        raise ValueError(
            "sharded runner supports a replicated (unbatched) edge_state "
            "only; shard per-scenario initial screens with run_batch per "
            "shard instead")
    group, world = mesh.get_group(), mesh.size()
    turb_state = (None if turb_generator is None
                  else (turb_generator.device, turb_generator.get_state()))

    def run(scen: ScenarioBatch) -> MonteCarloStats:
        n = scen.start_step.shape[0]
        if n % world:
            raise ValueError(f"{n} scenarios over {world} ranks: pad to a "
                             "multiple (mesh.pad_to_devices)")
        tg = None if turb_state is None else torch.Generator(
            device=turb_state[0]).set_state(turb_state[1])
        out = run_batch(models, layers, cfg, scen, n_steps, solver,
                        shared_window, edge_model=edge_model,
                        edge_state=edge_state,
                        shared_turbulence=shared_turbulence, turb_generator=tg,
                        rows=multihost.scenario_rows(n, mesh))
        sums, mx = _local_sums(out, n_steps)
        dist.all_reduce(sums, op=dist.ReduceOp.SUM, group=group)
        dist.all_reduce(mx, op=dist.ReduceOp.MAX, group=group)
        return _finish(sums, mx)

    return run


def run_sharded(models: closed_loop.LoopModels, layers, cfg: SystemConfig,
                scen: ScenarioBatch, n_steps: int, mesh,
                solver: str | None = None,
                shared_window: bool = False) -> MonteCarloStats:
    """One-shot ``make_sharded_runner(...)(scen)``: the statistics of the
    global batch, sharded over the mesh's ranks."""
    return make_sharded_runner(models, layers, cfg, n_steps, mesh, solver,
                               shared_window)(scen)
