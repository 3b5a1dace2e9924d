"""Where the conditional-Gaussian flow's step cost goes (port of the
repository's ``benchmarks/edge_flow_breakdown.py``).

The reference-parity conditional flow (ops/edge_flow.py,
telescopeAbstract.m:288-372) costs more a step than the periodic fast
path.  This decomposes it:

  breakdown rows (one advance()-like step a loop iteration, the shared
  (L, n, n) state carried), built on the port's own pieces of
  edge_flow.advance -- _draw_borders, _embed, _shift, _sample:
    draws            border conditional-Gaussian draws only (A Z + B eps),
                     as many a step as advance draws (one a shift round
                     that moves a layer, one for the output sample)
    draws_embed      + frame assembly (pad + ring scatter)
    no_frac          + exact whole-pixel shifts (no output-side bilinear)
    full_new         the whole advance()
    full_new_bf16ops advance() with the operators A and Bc in bfloat16
                     (float32 accumulation)

  closed-loop rows (montecarlo.run_batch): the per-step cost of the
  conditional flow with one shared realization (shared_turbulence=
  "verified", advanced once a step and broadcast) against the periodic
  flow's shared window, at B=1 and at EFB_BATCH.

Each row is the median and IQR over EFB_REPEATS runs of EFB_STEPS steps
after a warm-up run: by CUDA events around each run on the card
(profiling.cuda_times_ms), by the host clock on the CPU.  The flow is
host-bound, so each closed-loop row also gives the host clock of as many
synchronized runs (``host_us_per_step``, ``host_iqr_us``).  The JAX
script's A/B rows of its TPU layout variants have no counterpart here and
are named under ``"not_ported"`` with the reason.  ``device`` is the
card's name and power limit.  With out.json given and holding a report
of the same device, resolution, steps, repeats and batch, its finished
rows are kept and only the missing ones measured (a staged run; the
closed-loop rows a (flow, batch) pair at a time); another report's rows
are not merged.

Usage: python -m mpc_sensorlessao_tpu_torch.benchmarks.edge_flow_breakdown
       [out.json]
Env:   EFB_RES=128  EFB_STEPS=25  EFB_REPEATS=9  EFB_BATCH=64
       EFB_SKIP_LOOPS=1 (breakdown rows only)
       EFB_DEVICE=cuda (the card unless "cpu" is named; the CPU runs the
       closed-loop rows at B=1 and 4)
"""

from __future__ import annotations

import dataclasses
import json
import os
import statistics
import sys
import time

import numpy as np
import torch

from ..models import pipeline
from ..ops import edge_flow
from ..parallel import montecarlo
from ..utils.config import SystemConfig, reference_config
from . import _protocol as P

STEPS = 25              # steps a timed run (EFB_STEPS)
REPEATS = 9             # timed runs a row (EFB_REPEATS)
NOT_PORTED = {
    "full_old": "edge_flow.advance_per_layer, the JAX per-layer advance: "
    "a TPU layout variant on the do-not-port list",
    "full_hybrid_switch": "edge_flow.advance_hybrid with the switch shift "
    "selection: a TPU layout variant on the do-not-port list (build() "
    "never selects it)",
    "full_hybrid_where": "edge_flow.advance_hybrid with the where shift "
    "selection: a TPU layout variant on the do-not-port list",
}


def not_ported(res: int) -> dict:
    """The JAX script's rows with no counterpart, by name, with the
    reason; the JAX script's shift-selection A/B row times the selection
    its size-based default does not take (switch up to 256 px)."""
    alt = "where" if res <= 256 else "switch"
    return {**NOT_PORTED, f"full_new_{alt}": (
        f"advance with the {alt} shift selection: the TPU-tuned "
        "switch/where selection is on the do-not-port list; the port "
        "shifts by slicing")}


def _stats(ms: list, steps: int, digits: int) -> tuple[float, list]:
    per = [1e3 * t / steps for t in ms]
    q = np.percentile(per, [25, 75])
    return (round(statistics.median(per), digits),
            [round(float(x), digits) for x in q])


def breakdown_steps(model: edge_flow.EdgeFlowModel, model_bf,
                    gen: torch.Generator) -> dict:
    """The breakdown rows' steps, by name: step(phases (1, L, n, n), idx)
    -> (phases', total), the border noise from ``gen``."""
    n = model.size

    def noise(m, phases):
        return torch.randn((1, m.n_layers, m.n_border), generator=gen,
                           device=phases.device, dtype=phases.dtype)

    def perturb(phases, x):
        return phases * (1.0 + 1e-12 * x)

    def sched_of(idx):
        sched = edge_flow.schedule(model, np.atleast_1d(np.float32(idx)))
        return sched, edge_flow.shift_rounds(sched)

    def draws(phases, idx, embed=False):
        tot = 0.0
        for _ in range(sched_of(idx)[1] + 1):
            b = edge_flow._draw_borders(model, phases, noise(model, phases))
            tot = tot + (torch.sum(edge_flow._embed(model, phases, b))
                         if embed else torch.sum(b))
        return perturb(phases, tot), tot

    def no_frac(phases, idx):
        # the integer-lattice update, without the output-side bilinear
        sched, rounds = sched_of(idx)
        for s in range(rounds):
            frames = edge_flow._embed(model, phases, edge_flow._draw_borders(
                model, phases, noise(model, phases)))
            new = []
            for l, (ky, kx, (sgn_y, sgn_x), _, _) in enumerate(sched):
                d = (sgn_y if s < abs(int(ky[0])) else 0,
                     sgn_x if s < abs(int(kx[0])) else 0)
                new.append(phases[:, l] if d == (0, 0)
                           else edge_flow._shift(frames[:, l], n, *d))
            phases = torch.stack(new, dim=1)
        # one more draw: the output sample's
        b = edge_flow._draw_borders(model, phases, noise(model, phases))
        return phases, torch.sum(b)

    def full(m):
        def step(phases, idx):
            st, ph = edge_flow.advance(
                m, edge_flow.EdgeFlowState(phases=phases[0]), idx, gen)
            return st.phases[None], torch.sum(ph)
        return step

    return {"draws": draws,
            "draws_embed": lambda p, i: draws(p, i, embed=True),
            "no_frac": no_frac, "full_new": full(model),
            "full_new_bf16ops": full(model_bf)}


def breakdown_rows(model, state0, dev, steps: int, repeats: int,
                   done=None, save=None) -> dict:
    """Each breakdown row's us a step (median, IQR) over ``steps``-long
    runs from ``state0``; rows in ``done`` are kept."""
    model_bf = dataclasses.replace(model, A=model.A.to(torch.bfloat16),
                                   Bc=model.Bc.to(torch.bfloat16))
    gen = P.generator(dev, 3)
    rows = dict(done or {})
    for name, step in breakdown_steps(model, model_bf, gen).items():
        if name in rows:
            continue

        def run(step=step):
            phases = state0.phases[None]
            for idx in range(steps):
                phases, _ = step(phases, idx)
            return phases
        med, iqr = _stats(P.times_ms(run, dev, repeats), steps, 2)
        rows[name] = {"us_per_step": med, "iqr_us": iqr}
        print(name, rows[name], file=sys.stderr, flush=True)
        if save is not None:
            save(rows)
    return rows


def loop_cfg(res: int, steps: int, flow: str) -> SystemConfig:
    """reference_config(res) on ``flow`` with the 300 / 50 ID split and
    ``steps`` test steps (edge_flow_breakdown.py:206-210)."""
    cfg = reference_config(resolution=res)
    return cfg.replace(
        atmosphere=dataclasses.replace(cfg.atmosphere, flow=flow),
        sim=dataclasses.replace(cfg.sim, n_train=300, n_valid=50,
                                n_test=steps))


def loop_marginal(res: int, batches, steps: int, repeats: int, dev,
                  done=None, save=None) -> dict:
    """Per-step closed-loop cost: periodic vs conditional (shared), one
    build per flow reused across every batch size.  A (flow, batch) row
    in ``done`` is kept as it is and not measured again; a flow is built
    only where one of its rows is missing."""
    out = {f"B={b}": {} for b in batches}
    for b, row in (done or {}).items():  # staged resume
        if b in out:
            out[b].update({k: v for k, v in row.items()
                           if k in ("periodic", "conditional")})
    for flow in ("periodic", "conditional"):
        todo = [b for b in batches if flow not in out[f"B={b}"]]
        if not todo:
            continue
        cfg = loop_cfg(res, steps, flow)
        t0 = time.time()
        system = pipeline.build(cfg, dev)
        P.sync(dev)
        build_s = time.time() - t0
        for batch in todo:
            scen = montecarlo.make_scenarios(
                cfg, torch.Generator().manual_seed(1), batch, device=dev)
            montecarlo.assert_shared_window(scen)
            if flow == "conditional":
                kw = dict(edge_model=system.edge_model,
                          edge_state=system.edge_state,
                          shared_turbulence="verified")
            else:
                kw = dict(shared_window="verified")

            def run(scen=scen, kw=kw):
                return montecarlo.run_batch(system.loop, system.layers, cfg,
                                            scen, n_steps=steps, **kw)
            ev = P.times_ms(run, dev, repeats)
            host = (P.host_times_ms(run, dev, repeats) if dev.type == "cuda"
                    else ev)
            med, iqr = _stats(ev, steps, 1)
            host_med, host_iqr = _stats(host, steps, 1)
            out[f"B={batch}"][flow] = {
                "build_s": round(build_s, 1),
                "us_per_step": med,
                "us_per_step_per_scen": round(med / batch, 2),
                "iqr_us": iqr,
                "host_us_per_step": host_med,
                "host_iqr_us": host_iqr,
            }
            print(f"B={batch} {flow}", out[f"B={batch}"][flow],
                  file=sys.stderr, flush=True)
            if save is not None:
                save(out)
        del system
    for b in batches:
        row = out[f"B={b}"]
        row["conditional_overhead_us_per_step"] = round(
            row["conditional"]["us_per_step"]
            - row["periodic"]["us_per_step"], 1)
    return out


def main(argv=None, env=None) -> dict:
    """Run (or resume) the rows; returns the report, prints it, and
    writes it to the out.json argument when one is given."""
    argv = sys.argv[1:] if argv is None else list(argv)
    env = os.environ if env is None else env
    out_path = argv[0] if argv else None
    dev = P.device(env, "EFB_DEVICE")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    res = int(env.get("EFB_RES", "128"))
    batch = int(env.get("EFB_BATCH", "64"))
    steps = int(env.get("EFB_STEPS", STEPS))
    repeats = int(env.get("EFB_REPEATS", REPEATS))

    cfg = reference_config(resolution=res)
    tel = dataclasses.replace(cfg.telescope, resolution=res)
    t0 = time.time()
    model, state0 = edge_flow.build(0, cfg.atmosphere, tel, device=dev)
    P.sync(dev)
    build_s = time.time() - t0

    report = {
        "what": ("Conditional-Gaussian flow cost breakdown "
                 "(telescopeAbstract.m:288-372 parity path): component "
                 "knockouts of advance() and closed-loop marginal cost "
                 "with the shared-turbulence Monte-Carlo amortization. "
                 "Medians and IQRs over repeats, by CUDA events on the "
                 "card (host clock on the CPU); the closed-loop rows also "
                 "by the host clock."),
        "resolution": res, "device": P.device_name(dev),
        "scan_steps": steps, "repeats": repeats, "batch": batch,
        "n_layers": model.n_layers,
        "nsub": list(map(list, model.nsub)),
        "operator_build_s": round(build_s, 1),
        "advance_breakdown": {},
        "closed_loop": {},
        "not_ported": not_ported(res),
    }
    P.load_report(out_path, report, ("advance_breakdown", "closed_loop"),
                  knobs=("resolution", "scan_steps", "repeats", "batch"))

    def _save(rows=None):
        if rows is not None:
            report["advance_breakdown"] = rows
        P.save_report(report, out_path)

    report["advance_breakdown"] = breakdown_rows(
        model, state0, dev, steps, repeats,
        done=report["advance_breakdown"], save=_save)

    if not env.get("EFB_SKIP_LOOPS"):
        bsizes = [1, 4] if dev.type == "cpu" else [1, batch]
        need = any(f not in report["closed_loop"].get(f"B={b}", {})
                   for b in bsizes for f in ("periodic", "conditional"))
        if need:
            def _save_loops(out):
                report["closed_loop"] = out
                _save()
            report["closed_loop"] = loop_marginal(
                res, bsizes, steps, repeats, dev,
                done=report["closed_loop"], save=_save_loops)

    _save()
    print(json.dumps(report, indent=2))
    return report


if __name__ == "__main__":
    main()
