"""Tensor-parallel estimator: measurement-dimension sharding (port of
``mpc_sensorlessao_tpu/parallel/estimator_tp.py``).

For configurations where one estimator evaluation outgrows one device --
very large pupils or wide-field mosaics, where the stacked measurement
p = n_div (2c+1)^2 and the linearized operators A_s / S get large -- the
pixel dimension p is split over the ranks of a 1-D mesh:

* estimate: S (nx, p) is split by columns and y by its last dim; each
  rank contracts its slice and one ``all_reduce`` sums the (nx,)
  partials;
* normal equations: A_s (p, nx) is split by rows; each rank forms its
  shard's (nx, nx) Gram and (nx,) gradient, and two ``all_reduce``s sum
  them.

Every rank passes the whole tensors (on its device) and takes its own
slice; the results are whole on every rank.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from .mesh import axis_mesh

TP_AXIS = "tp"


def tp_mesh(n_devices: int | None = None, device_type: str = "cuda"):
    """1-D mesh over the tensor-parallel axis (mesh.axis_mesh)."""
    return axis_mesh(TP_AXIS, n_devices, device_type)


def pad_to(x: torch.Tensor, mult: int, axis: int) -> torch.Tensor:
    """Zero-pad so x.shape[axis] is a multiple of mult (zeros are inert in
    every contraction here)."""
    r = (-x.shape[axis]) % mult
    if r == 0:
        return x
    shape = list(x.shape)
    shape[axis] = r
    return torch.cat([x, x.new_zeros(shape)], dim=axis)


def _shard(x: torch.Tensor, mesh, axis: int) -> torch.Tensor:
    """This rank's contiguous block of x (padded to the mesh) along axis."""
    n = mesh.size()
    x = pad_to(x, n, axis)
    k = x.shape[axis] // n
    return x.narrow(axis, mesh.get_local_rank() * k, k)


def sharded_estimate(solve_op: torch.Tensor, b_s: torch.Tensor,
                     y: torch.Tensor, mesh) -> torch.Tensor:
    """x = (y - b_s) @ solve_op.T with the p dimension split over the mesh.

    solve_op: (nx, p); b_s: (p,); y: (..., p).  Each rank contracts its
    p/n columns; one all_reduce sums the (..., nx) partials.
    """
    part = (_shard(y, mesh, -1) - _shard(b_s, mesh, 0)) @ _shard(
        solve_op, mesh, 1).T
    dist.all_reduce(part, group=mesh.get_group())
    return part


def sharded_normal_equations(A_s: torch.Tensor, y_res: torch.Tensor, mesh):
    """(A' A, A' y) with the p dimension (A_s's rows) split over the mesh:
    the building block of re-linearized Gauss-Newton at scale -- each
    rank forms its shard's (nx, nx) Gram and (nx,) gradient, and two
    all_reduces sum them (p can be millions; nx stays small)."""
    A = _shard(A_s, mesh, 0)
    y = _shard(y_res, mesh, 0)
    G = A.T @ A
    g = y @ A
    group = mesh.get_group()
    dist.all_reduce(G, group=group)
    dist.all_reduce(g, group=group)
    return G, g
