"""Device meshes for scenario-parallel Monte-Carlo (port of
``mpc_sensorlessao_tpu/parallel/mesh.py``).

A mesh is a 1-D ``torch.distributed.device_mesh.DeviceMesh`` over the
ranks of the initialized world (multihost.initialize, multihost.spawn),
one device per rank; its group carries the collectives of the sharded
runner, the tensor-parallel estimator and the horizon-parallel solve.
The JAX package's ``scenario_sharding`` and ``replicated`` (the
NamedShardings of per-scenario and replicated arrays) have no
counterpart here: a torch rank holds whole tensors, the replicated
operators on its own device and the global scenario batch, and takes its
rows explicitly (multihost.scenario_rows).
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

SCENARIO_AXIS = "scenario"


def axis_mesh(axis: str, n_devices: int | None = None,
              device_type: str = "cuda") -> DeviceMesh:
    """1-D mesh named ``axis`` over the first ``n_devices`` ranks (default:
    every rank) of the initialized world, on ``device_type`` -- "cuda"
    unless the caller names "cpu".  Each rank's current CUDA device is
    the one it set (multihost.spawn sets it); raises without a device of
    that type or an initialized process group."""
    torch.empty(0, device=device_type)      # no such device: raises here
    if not dist.is_initialized():
        raise RuntimeError("no process group: call multihost.initialize "
                           "or run under multihost.spawn first")
    n = dist.get_world_size() if n_devices is None else n_devices
    return init_device_mesh(device_type, (n,), mesh_dim_names=(axis,))


def scenario_mesh(n_devices: int | None = None,
                  device_type: str = "cuda") -> DeviceMesh:
    """1-D mesh over the scenario (Monte-Carlo) axis."""
    return axis_mesh(SCENARIO_AXIS, n_devices, device_type)


def pad_to_devices(n: int, n_devices: int) -> int:
    """Smallest multiple of n_devices >= n (every rank runs as many
    scenarios)."""
    return ((n + n_devices - 1) // n_devices) * n_devices
