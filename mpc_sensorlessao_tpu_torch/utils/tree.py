"""Dataclasses of tensors: the port's counterpart of JAX pytrees."""

from __future__ import annotations

import dataclasses

import torch


def cast(obj, dtype: torch.dtype | None = None, device=None):
    """Copy of a (nested) dataclass with every tensor field moved to
    ``device`` and every floating-point tensor cast to ``dtype`` (None
    keeps it)."""
    def one(v):
        if isinstance(v, torch.Tensor):
            dt = dtype if dtype is not None and v.is_floating_point() else None
            return v.to(dtype=dt, device=device)
        if dataclasses.is_dataclass(v) and not isinstance(v, type):
            return cast(v, dtype, device)
        return v

    return dataclasses.replace(obj, **{
        f.name: one(getattr(obj, f.name))
        for f in dataclasses.fields(obj) if f.init})
