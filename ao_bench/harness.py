"""The benchmark of the PyTorch port, driven by data.

A cell of ``BENCHMARK.json`` names a configuration (its file of sizes
under ``configs/``) and a traffic mix; ``workloads/<cell>.json`` holds
the cell's traffic: the scenario batch, its SNR and D/r0 grid, the
window mode, the episode length, the measure route, and the limits of
the comparison that decides ``correct``.  Each metric is a reader under
``metrics/``, found by its name.  A new cell, configuration or metric is
new files and new entries, never an edit.

One run: build the port's system (set-up), warm it up on the cell's
shapes, then run whole episodes back to back for the window's seconds.
An episode is one ``montecarlo.run_batch`` of the configuration's test
steps over the cell's batch, with its own noise seed (and, for
decorrelated windows, its own start steps) drawn from ``--seed`` and the
episode's index.  After the window, sampled (scenario, step) pairs of
every episode are checked against the float64 reference.
"""

from __future__ import annotations

import copy
import dataclasses
import importlib.util
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from . import check, trace, yardstick

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "mpc_sensorlessao_tpu")


class BenchError(RuntimeError):
    """A run that cannot give a result."""


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def merge(base: dict, over: dict) -> dict:
    """``base`` with the nested groups of ``over`` laid over it."""
    out = copy.deepcopy(base)
    for k, v in over.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = merge(out[k], v)
        else:
            out[k] = v
    return out


class Cell:
    """One cell of BENCHMARK.json with its configuration and traffic."""

    def __init__(self, name: str, root: Path = ROOT):
        bench = load_json(root / "BENCHMARK.json")
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise BenchError(f"no workload {name!r} in BENCHMARK.json")
        self.name = name
        self.entry = cells[name]
        configs = {c["name"]: c for c in bench["configs"]}
        self.traffic = load_json(HERE / "workloads" / f"{name}.json")
        cfg = load_json(root / configs[self.entry["config"]]["file"])
        self.config = merge(cfg, self.traffic.get("overrides", {}))
        self.config["sim"]["n_test"] = self.traffic["episode_steps"]
        self.metrics = [m for m in bench["end_to_end"]
                        if name in m.get("workloads", [name])]
        self.per_layer = [m for m in bench["per_layer"]
                          if name in m.get("workloads", [name])]

    def rehearse(self) -> None:
        """Cut the cell to the CPU rehearsal's tiny size (tests only):
        ``rehearsal.json``, with what the cell's own ``rehearsal`` group
        overrides."""
        r = merge(load_json(HERE / "rehearsal.json"),
                  self.traffic.get("rehearsal", {}))
        cfg = self.config
        for group in ("telescope", "estimator"):
            cfg[group]["resolution"] = r["resolution"]
        cfg["sim"].update(n_train=r["n_train"], n_valid=r["n_valid"],
                          n_test=r["episode_steps"])
        self.traffic = merge(self.traffic, {
            "batch": r["batch"], "check": r["check"], "limits": r["limits"],
            "episode_steps": r["episode_steps"],
            "start_range": r.get("start_range",
                                 self.traffic.get("start_range"))})


# -- the program under test ----------------------------------------------
def program_config(cfg: dict):
    """The port's SystemConfig of a configuration file."""
    from mpc_sensorlessao_tpu_torch.utils import config as pc
    groups = {"telescope": pc.TelescopeConfig,
              "atmosphere": pc.AtmosphereConfig, "zernike": pc.ZernikeConfig,
              "dm": pc.DMConfig, "estimator": pc.EstimatorConfig,
              "mpc": pc.MPCConfig, "sim": pc.SimConfig}
    kw = {}
    for group, cls in groups.items():
        names = {f.name for f in dataclasses.fields(cls)}
        vals = {k: tuple(v) if isinstance(v, list) else v
                for k, v in cfg[group].items() if k in names}
        missing = names - set(vals)
        if missing:
            raise BenchError(f"configuration group {group} lacks "
                             f"{sorted(missing)}")
        kw[group] = cls(**vals)
    return pc.SystemConfig(**kw)


class Program:
    """The port's system of one cell, built and warmed up."""

    def __init__(self, cell: Cell, device: torch.device):
        from mpc_sensorlessao_tpu_torch.models import estimator, pipeline
        from mpc_sensorlessao_tpu_torch.ops import psf_kernels
        self.kernels = psf_kernels
        self.cfg = program_config(cell.config)
        self.device = device
        t0 = time.perf_counter()
        system = pipeline.build(self.cfg, device)
        start = self.cfg.sim.n_train + self.cfg.sim.n_valid
        self.init_u = (pipeline.warm_start_command(system, self.cfg, start)
                       if self.cfg.mpc.warm_start else None)
        sync(device)
        self.build_s = time.perf_counter() - t0
        route = cell.traffic.get("route", "sym3")
        self.loop = dataclasses.replace(
            system.loop, est=estimator.with_route(system.loop.est, route))
        self.layers = system.layers
        self.shared = ("verified" if cell.traffic["window"] == "shared"
                       else False)

    def episode(self, scen, n_steps: int):
        from mpc_sensorlessao_tpu_torch.parallel import montecarlo
        out = montecarlo.run_batch(
            self.loop, self.layers, self.cfg, scen, n_steps,
            shared_window=self.shared, init_u=self.init_u)
        return {k: getattr(out, k) for k in check.FIELDS}

    def counters(self) -> dict:
        k = self.kernels
        return {"b1_launches": k.psf_crop_diversity_sym3.launches}


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


# -- traffic ---------------------------------------------------------------
def episode_seed(seed: int, episode: int, stream: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([seed, episode,
                                                         stream]))


class Traffic:
    """The scenario grid of a cell: batch rows ordered D/r0, then SNR,
    then repetition, each (D/r0, SNR) pair with the same count."""

    def __init__(self, cell: Cell):
        t, cfg = cell.traffic, cell.config
        self.B = t["batch"]
        grid = [(d, s) for d in t["d_over_r0"] for s in t["snr_db"]]
        if self.B % len(grid):
            raise BenchError(f"batch {self.B} is not a multiple of the "
                             f"{len(grid)} grid points")
        reps = self.B // len(grid)
        snr_cfg = cfg["estimator"]["snr_db"]
        self.mag = np.repeat([(d / 5.0) ** (5.0 / 6.0) for d, _ in grid],
                             reps).astype(np.float32)
        self.scale = np.repeat([10.0 ** ((snr_cfg - s) / 20.0)
                                for _, s in grid], reps).astype(np.float32)
        self.window = t["window"]
        if self.window not in ("shared", "decorrelated"):
            raise BenchError(f"unknown window mode {self.window!r}")
        self.start = cfg["sim"]["n_train"] + cfg["sim"]["n_valid"]
        self.range = t.get("start_range")
        self.steps = cfg["sim"]["n_test"]

    def scenarios(self, seed: int, episode: int) -> dict:
        """One episode's starts (B,) float32, magnification, noise
        multiplier and noise seed, all from (seed, episode)."""
        if self.window == "shared":
            starts = np.full(self.B, self.start, dtype=np.float32)
        else:
            lo, hi = self.range
            starts = episode_seed(seed, episode, 1).integers(
                lo, hi, self.B).astype(np.float32)
        noise = int(episode_seed(seed, episode, 0).integers(0, 2 ** 62))
        return {"start": starts, "mag": self.mag, "scale": self.scale,
                "noise_seed": noise}


def scenario_batch(sc: dict, device: torch.device):
    from mpc_sensorlessao_tpu_torch.parallel.montecarlo import ScenarioBatch

    def f32(a):
        return torch.as_tensor(a, dtype=torch.float32, device=device)
    return ScenarioBatch(start_step=f32(sc["start"]), mag=f32(sc["mag"]),
                         noise_scale=f32(sc["scale"]),
                         noise_seed=sc["noise_seed"])


# -- the run ---------------------------------------------------------------
def load_reader(name: str):
    """The reader of metric ``name``: metrics/<name>.py's ``read``."""
    path = HERE / "metrics" / f"{name}.py"
    if not path.is_file():
        raise BenchError(f"metric {name!r} has no reader {path}")
    spec = importlib.util.spec_from_file_location(f"ao_bench_metric_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def run(cell: Cell, seed: int, seconds: float, trace_on: bool,
        device: torch.device, t_start: float, control: str | None = None,
        log=print) -> dict:
    """One run; returns the result's fields (the caller prints them)."""
    seed = int(seed) % 2 ** 63
    traffic = Traffic(cell)
    T = traffic.steps
    log(f"set-up: imports and device {time.perf_counter() - t_start:.2f} s")
    if control is None:
        prog = Program(cell, device)
        log(f"set-up: pipeline.build and warm start {prog.build_s:.2f} s")
        t0 = time.perf_counter()
        warm = traffic.scenarios(seed, 0)
        prog.episode(scenario_batch(warm, device), min(3, T))
        sync(device)
        log(f"set-up: warm-up {time.perf_counter() - t0:.2f} s")
        build_s = prog.build_s
    else:
        from .reference.system import Reference
        ref_ctl = Reference(cell.config, device, precision=control)
        build_s = None
    sync(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t_window = time.perf_counter()
    setup_s = t_window - t_start
    sampler = check.Sampler(cell.traffic["check"], traffic.B, T, seed)
    kept_n = torch.zeros((), dtype=torch.float64, device=device)
    failed_n = torch.zeros((), dtype=torch.float64, device=device)
    strehl_sum = torch.zeros((), dtype=torch.float64, device=device)
    records, tr = [], None
    e = 0
    while True:
        t_episode = time.perf_counter()
        sc = traffic.scenarios(seed, e)
        if control is None:
            batch = scenario_batch(sc, device)

            def go():
                return prog.episode(batch, T)
            if trace_on and e == 1:
                out, tr = trace.traced(go, T, prog.counters)
            else:
                out = go()
        else:
            draws = check.noise_draws(sc["noise_seed"], traffic.B,
                                      ref_ctl.b_s.numel(), device)
            out = ref_ctl.loop(sc["start"], sc["mag"], sc["scale"], T,
                               draws)
        ok = yardstick.kept(out["rms_res"], out["rms_turb"])
        s = yardstick.settled_from(T)
        strehl_sum += torch.where(
            ok, out["strehl_exact"][:, s:].double().mean(dim=1), 0.0).sum()
        kept_n += ok.sum()
        failed_n += (~ok).sum()
        records.append(sampler.keep(e, sc, out))
        del out
        go = batch = None
        sync(device)
        t_now = time.perf_counter()
        log(f"episode {e}: {t_now - t_episode:.3f} s")
        e += 1
        if (time.perf_counter() - t_window >= seconds
                and (not trace_on or control is not None or e >= 2)):
            break
    window_s = time.perf_counter() - t_window
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    found = forbidden_modules()
    if found:
        raise BenchError(f"loaded after the window: {', '.join(found)}")
    attempted = e * traffic.B
    ctx = {"solves": attempted * T, "window_s": window_s, "setup_s": setup_s,
           "build_s": build_s,
           "settled_strehl": float(strehl_sum / torch.clamp(kept_n, min=1)),
           "trace": tr, "traffic": cell.traffic, "config": cell.config,
           "yardstick": yardstick, "read": lambda name: load_reader(name)(ctx)}
    failed = int(failed_n)
    # the program's state is freed before the reference runs
    if control is None:
        del prog
    else:
        del ref_ctl
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    checks = check.compare(cell, records, device, log=log)
    log(f"reference check {time.perf_counter() - t0:.2f} s")
    metrics = {}
    for m in (cell.per_layer if trace_on else cell.metrics):
        value = load_reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": all(c["value"] <= c["limit"]
                             for c in checks.values()),
              "attempted": attempted, "failed": failed, "metrics": metrics,
              "device": device_info(device, peak, tr)}
    if trace_on and tr is not None:
        result["breakdown"] = tr.breakdown()
    result["checks"] = checks
    return result


def device_info(device: torch.device, peak: int, tr) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": 0}
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": 1, "memory_peak_bytes": int(peak)}
    if tr is not None:
        info["busy_s"] = tr.busy_s
        info["window_s"] = tr.window_s
    return info
