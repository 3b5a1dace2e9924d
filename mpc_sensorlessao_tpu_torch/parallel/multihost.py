"""Multi-process execution of the scenario-sharded runner (port of
``mpc_sensorlessao_tpu/parallel/multihost.py``).

BASELINE config 5: 100k+ scenario rollouts over many devices, statistics
reduced by collectives.  Each process is one rank with one device; the
backend follows the device -- NCCL between cards, gloo between CPU
ranks.  Every rank builds the same system and the same global scenario
batch (both deterministic from their seeds) and runs only its contiguous
rows of it (``scenario_rows``).

Run on every host, one process a card:
    python -m mpc_sensorlessao_tpu_torch.parallel.multihost \\
        --coordinator=HOST0:1234 --num-processes=N --process-id=i

or, on one host, ``spawn(fn, world_size)`` starts the ranks itself.
"""

from __future__ import annotations

import datetime
import os
import tempfile
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

# how long a collective, and the rendezvous, may wait for a rank
TIMEOUT = datetime.timedelta(seconds=600)
# host thread pools of a spawned rank (numpy's BLAS, OpenMP): the host's
# cores split between the ranks unless the caller's environment sets them
THREAD_VARS = ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS")


def default_backend(device: torch.device | str) -> str:
    """NCCL for CUDA ranks, gloo for CPU ranks."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def initialize(coordinator: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None,
               device: torch.device | str = "cuda",
               backend: str | None = None) -> None:
    """``init_process_group`` over ``tcp://<coordinator>`` (host:port of
    rank 0) with the backend of ``device`` unless ``backend`` is given;
    a no-op without a coordinator."""
    if coordinator is None:
        return
    dist.init_process_group(backend or default_backend(device),
                            init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id,
                            timeout=TIMEOUT)


def scenario_rows(n_scenarios: int, mesh) -> slice:
    """This rank's contiguous rows of a global batch of ``n_scenarios``
    (a multiple of the mesh size) -- the counterpart of the JAX
    ``global_scenarios``, which assembles such process-local rows into
    one global array."""
    world, rank = mesh.size(), mesh.get_local_rank()
    per = n_scenarios // world
    return slice(rank * per, (rank + 1) * per)


def rank_device(device: torch.device | str, rank: int) -> torch.device:
    """The device of ``rank``: "cuda" means the rank's own card
    (cuda:<rank mod cards>), "cuda:k" puts every rank on card k."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", rank % torch.cuda.device_count())
    return dev


def _entry(rank: int, fn, world_size: int, backend: str, device: str,
           init_method: str, out_dir: str, args: tuple) -> None:
    """One spawned rank: one intra-op thread, TF32 off, the rank's
    device, the process group; fn's result goes to out_dir."""
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = rank_device(device, rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank,
                            timeout=TIMEOUT)
    try:
        result = fn(rank, world_size, dev, *args)
        torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn(fn, world_size: int, backend: str | None = None,
          device: torch.device | str = "cuda", args: tuple = (),
          timeout: float = 900.0) -> list:
    """Run ``fn(rank, world_size, device, *args)`` in ``world_size``
    spawned processes joined in one process group, and return each
    rank's result (plain data: numbers, strings, lists, dicts, tensors).

    ``device`` "cuda" gives each rank its own card, "cuda:k" puts every
    rank on card k (then pass ``backend="gloo"``: NCCL refuses two ranks
    on one device), "cpu" runs CPU ranks; the backend defaults to the
    device's (default_backend).  The ranks meet through a file store in
    a fresh temporary directory, so concurrent worlds never share a
    port.  Each rank gets cores / world_size host threads (THREAD_VARS)
    unless the environment sets them.  ``fn`` must be importable by name
    from a module that the children can import.  A rank that raises or
    dies, or a world still running after ``timeout`` seconds, stops
    every rank and raises here: nothing is retried.
    """
    torch.empty(0, device=device)       # no such device: raises here
    backend = backend or default_backend(device)
    threads = str(max(1, (os.cpu_count() or 1) // world_size))
    saved = {k: os.environ.get(k) for k in THREAD_VARS}
    with tempfile.TemporaryDirectory(prefix="mpcsao_spawn_") as tmp:
        try:
            for k in THREAD_VARS:
                os.environ.setdefault(k, threads)
            ctx = mp.start_processes(
                _entry, args=(fn, world_size, backend, str(device),
                              f"file://{os.path.join(tmp, 'store')}", tmp,
                              tuple(args)),
                nprocs=world_size, join=False, start_method="spawn")
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        deadline = time.monotonic() + timeout
        while not ctx.join(timeout=5.0):
            if time.monotonic() > deadline:
                for p in ctx.processes:
                    if p.is_alive():
                        p.terminate()
                for p in ctx.processes:
                    p.join(30.0)
                raise TimeoutError(f"spawned world of {world_size} ranks "
                                   f"still running after {timeout} s")
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           weights_only=True) for r in range(world_size)]


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("--coordinator", default=None)
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument("--scenarios-per-device", type=int, default=16)
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--resolution", type=int, default=128)
    p.add_argument("--local-rank", type=int,
                   default=int(os.environ.get("LOCAL_RANK", "-1")))
    p.add_argument("--device", default=None,
                   help="the rank's device (default cuda:<local rank>)")
    args = p.parse_args(argv)

    rank = args.process_id or 0
    local = args.local_rank if args.local_rank >= 0 else rank
    dev = torch.device(args.device or f"cuda:{local}")
    torch.empty(0, device=dev)          # no such device: raises here
    torch.backends.cuda.matmul.allow_tf32 = False
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    with tempfile.TemporaryDirectory(prefix="mpcsao_world_") as tmp:
        if args.coordinator is None:
            # one process: a world of one rank
            dist.init_process_group(
                default_backend(dev), world_size=1, rank=0,
                init_method=f"file://{os.path.join(tmp, 'store')}",
                timeout=TIMEOUT)
        else:
            initialize(args.coordinator, args.num_processes, rank, dev)
        try:
            _run_main(args, dev)
        finally:
            dist.destroy_process_group()


def _run_main(args, dev: torch.device) -> None:
    import dataclasses
    import json

    from ..models import pipeline
    from ..utils.config import reference_config
    from . import mesh as mesh_lib
    from . import montecarlo

    cfg = reference_config(resolution=args.resolution)
    cfg = cfg.replace(sim=dataclasses.replace(
        cfg.sim, n_train=300, n_valid=50, n_test=args.steps))
    system = pipeline.build(cfg, dev)
    mesh = mesh_lib.scenario_mesh(device_type=dev.type)
    n = args.scenarios_per_device * mesh.size()
    scen = montecarlo.make_scenarios(
        cfg, torch.Generator().manual_seed(1), n, device=dev)
    stats = montecarlo.run_sharded(system.loop, system.layers, cfg,
                                   scen, n_steps=args.steps, mesh=mesh)
    if dist.get_rank() == 0:
        print(json.dumps(stats.as_floats()))


if __name__ == "__main__":
    main()
