"""The comparison that decides ``correct``.

Every episode of the window hands over, for a few scenarios drawn from
the seed (one from each equal stratum of the batch), their whole
trajectories of the commands ``u``, estimates ``x_est``, residual and
turbulence RMS and exact Strehl.  For each such scenario a set of steps
is drawn from the seed (always the first three and the last), and the
float64 reference computes each of those steps from the loop state the
program carried into it -- its two previous commands and its previous
estimate, which are among its outputs -- and the same noise draws (the
measurement noise comes from a torch generator seeded with the
episode's noise seed, so it is regenerated draw for draw).  The first
step starts from the reference's own initial state (zero, or its own
warm-start command).

Numbers compared, each the widest over all checked pairs:
  x_est_gap      |x_est - ref| / median |ref|   (L2 over the modes)
  u_gap          |u - ref| / median |ref|       (L2 over the actuators)
  strehl_gap     |strehl_exact - ref|
  rms_res_gap    |rms_res - ref| / median ref

The turbulence RMS alone is not compared: it is elementwise float32
work that no lower-precision product touches, so no control separates
it; the turbulence enters the residual phase that rms_res_gap and the
estimate compare.
"""

from __future__ import annotations

import numpy as np
import torch

FIELDS = ("u", "x_est", "rms_res", "rms_turb", "strehl_exact")
NUMBERS = ("x_est_gap", "u_gap", "strehl_gap", "rms_res_gap")
PAIR_CHUNK = 64


def noise_draws(noise_seed: int, B: int, p: int, device):
    """t -> the (B, p) float32 standard normals of step t, drawn in order
    from a generator on ``device`` seeded with ``noise_seed``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(noise_seed)
    state = {"t": 0}

    def draw(t: int) -> torch.Tensor:
        if t != state["t"]:
            raise ValueError(f"noise draws are taken in order, not {t}")
        state["t"] += 1
        return torch.randn((B, p), generator=gen, dtype=torch.float32,
                           device=device)
    return draw


class Sampler:
    """Which (scenario, step) pairs of each episode are checked."""

    def __init__(self, spec: dict, B: int, T: int, seed: int):
        self.rows, self.steps = spec["rows_per_episode"], spec["steps_per_row"]
        self.B, self.T, self.seed = B, T, seed

    def keep(self, episode: int, sc: dict, out: dict) -> dict:
        rng = np.random.default_rng(np.random.SeedSequence(
            [self.seed, episode, 2]))
        edges = np.linspace(0, self.B, self.rows + 1).astype(int)
        rows = np.array([rng.integers(lo, hi)
                         for lo, hi in zip(edges[:-1], edges[1:])])
        fixed = sorted({0, 1, 2, self.T - 1} & set(range(self.T)))
        rest = np.setdiff1d(np.arange(self.T), fixed)
        extra = rng.choice(rest, size=min(len(rest),
                                          max(self.steps - len(fixed), 0)),
                           replace=False)
        steps = np.sort(np.concatenate([fixed, extra])).astype(int)
        idx = torch.as_tensor(rows, device=out["u"].device)
        return {"rows": rows, "steps": steps,
                "start": sc["start"][rows], "mag": sc["mag"][rows],
                "scale": sc["scale"][rows], "noise_seed": sc["noise_seed"],
                "out": {k: out[k].index_select(0, idx) for k in FIELDS}}


def compare(cell, records: list, device, log=print) -> dict:
    """Each number compared, with its limit from the cell's traffic."""
    from .reference.system import Reference
    ref = Reference(cell.config, device)
    B, T = cell.traffic["batch"], cell.config["sim"]["n_test"]
    p = ref.b_s.numel()
    nu, nx = ref.nu, ref.influence.shape[0]
    f64 = dict(dtype=torch.float64, device=device)
    init = (torch.zeros(nu, **f64) if ref.init_u is None else ref.init_u)
    prog = {k: [] for k in FIELDS}
    refs = {k: [] for k in FIELDS}
    for rec in records:
        rows = torch.as_tensor(rec["rows"], device=device)
        draw = noise_draws(rec["noise_seed"], B, p, device)
        z = torch.stack([draw(t).index_select(0, rows) for t in range(T)])
        o = {k: v.to(torch.float64) for k, v in rec["out"].items()}
        pairs = [(i, t) for i in range(len(rec["rows"])) for t in rec["steps"]]
        for c in range(0, len(pairs), PAIR_CHUNK):
            chunk = pairs[c:c + PAIR_CHUNK]
            i = torch.as_tensor([q[0] for q in chunk], device=device)
            t = torch.as_tensor([q[1] for q in chunk], device=device)
            u_hist = o["u"][i]                              # (P, T, nu)

            def at(hist, lag, before):
                back = (t - lag).clamp(min=0)
                val = hist[torch.arange(len(chunk), device=device), back]
                return torch.where((t >= lag)[:, None], val, before)
            u1 = at(u_hist, 1, init.expand(len(chunk), nu))
            u2 = at(u_hist, 2, torch.where((t == 1)[:, None], init,
                                           torch.zeros(nu, **f64)))
            x_pre = at(o["x_est"][i], 1, torch.zeros((len(chunk), nx), **f64))
            tn = t.cpu().numpy()
            inn = i.cpu().numpy()
            res = ref.step(rec["start"][inn] + tn.astype(np.float32),
                           rec["mag"][inn], rec["scale"][inn], u1, u2, x_pre,
                           tn == 0, z[t, i])
            for k in FIELDS:
                prog[k].append(o[k][i, t])
                refs[k].append(res[k].to(torch.float64))
    P = {k: torch.cat(v) for k, v in prog.items()}
    Rf = {k: torch.cat(v) for k, v in refs.items()}
    gaps = {
        "x_est_gap": rel_vec(P["x_est"], Rf["x_est"]),
        "u_gap": rel_vec(P["u"], Rf["u"]),
        "strehl_gap": widest(P["strehl_exact"] - Rf["strehl_exact"]),
        "rms_res_gap": widest(P["rms_res"] - Rf["rms_res"])
        / float(Rf["rms_res"].median()),
    }
    limits = cell.traffic["limits"]
    out = {k: {"value": gaps[k], "limit": limits[k]} for k in NUMBERS}
    log(f"checked {len(P['u'])} (scenario, step) pairs of "
        f"{len(records)} episodes against the float64 reference")
    return out


def widest(d: torch.Tensor) -> float:
    """The largest |d|; inf if any entry is not finite."""
    if not bool(torch.isfinite(d).all()):
        return float("inf")
    return float(d.abs().max())


def rel_vec(a: torch.Tensor, ref: torch.Tensor) -> float:
    """Widest L2 gap of rows over the median L2 norm of the reference."""
    gap = torch.linalg.vector_norm(a - ref, dim=-1)
    return widest(gap) / float(torch.linalg.vector_norm(ref, dim=-1).median())
