"""Checkpoint / resume for built systems, scenario batches and telemetry
(port of ``mpc_sensorlessao_tpu/utils/checkpoint.py``).

A checkpoint is a directory: ``tree.pt`` holds a tree -- nested
dataclasses, NamedTuples, dicts, lists and tuples of tensors, numpy
arrays and plain numbers, strings and None -- as one ``torch.save`` of
its tensors and a JSON description of its structure, and
``config.json`` the optional config.  The JAX package writes the same
trees with Orbax (a JAX library), so the two formats differ by design.

Loading unpickles tensors only (``weights_only``); the structure's
classes are looked up by name in this package and nowhere else.
"""

from __future__ import annotations

import dataclasses
import importlib
import json
import os
import tempfile
from typing import Any

import numpy as np
import torch

TREE_FILE = "tree.pt"
CONFIG_FILE = "config.json"
_PACKAGE = __name__.split(".")[0]


def _flatten(obj, leaves: list):
    """JSON-able description of ``obj``; its arrays go to ``leaves``."""
    if isinstance(obj, torch.Tensor):
        leaves.append(obj.detach().cpu())
        return {"tensor": len(leaves) - 1}
    if isinstance(obj, (np.ndarray, np.generic)):
        leaves.append(torch.from_numpy(np.array(obj)))
        return {"numpy": len(leaves) - 1, "scalar": np.ndim(obj) == 0
                and isinstance(obj, np.generic)}
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return {"value": obj}
    cls = type(obj)
    name = f"{cls.__module__}:{cls.__qualname__}"
    if dataclasses.is_dataclass(obj):
        return {"dataclass": name, "fields": {
            f.name: _flatten(getattr(obj, f.name), leaves)
            for f in dataclasses.fields(obj) if f.init}}
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return {"namedtuple": name, "fields": {
            k: _flatten(getattr(obj, k), leaves) for k in obj._fields}}
    if isinstance(obj, dict):
        if not all(isinstance(k, str) for k in obj):
            raise TypeError("checkpoint dicts need string keys")
        return {"dict": {k: _flatten(v, leaves) for k, v in obj.items()}}
    if isinstance(obj, (list, tuple)):
        return {cls.__name__: [_flatten(v, leaves) for v in obj]}
    raise TypeError(f"cannot checkpoint a {cls.__qualname__}")


def _class(name: str):
    module, qualname = name.split(":")
    if module.split(".")[0] != _PACKAGE:
        raise ValueError(f"checkpoint names a class outside {_PACKAGE}: "
                         f"{name}")
    obj = importlib.import_module(module)
    for part in qualname.split("."):
        obj = getattr(obj, part)
    return obj


def _unflatten(spec: dict, leaves: list):
    if "tensor" in spec:
        return leaves[spec["tensor"]]
    if "numpy" in spec:
        arr = leaves[spec["numpy"]].cpu().numpy()
        return arr[()] if spec["scalar"] else arr
    if "value" in spec:
        return spec["value"]
    if "dataclass" in spec or "namedtuple" in spec:
        cls = _class(spec.get("dataclass") or spec["namedtuple"])
        return cls(**{k: _unflatten(v, leaves)
                      for k, v in spec["fields"].items()})
    if "dict" in spec:
        return {k: _unflatten(v, leaves) for k, v in spec["dict"].items()}
    if "list" in spec:
        return [_unflatten(v, leaves) for v in spec["list"]]
    return tuple(_unflatten(v, leaves) for v in spec["tuple"])


def _strip(spec):
    """The structure of a description: its leaves by kind only."""
    for kind in ("tensor", "numpy", "value"):
        if kind in spec:
            return kind
    if "fields" in spec:
        return {**spec, "fields": {k: _strip(v)
                                   for k, v in spec["fields"].items()}}
    if "dict" in spec:
        return {"dict": {k: _strip(v) for k, v in spec["dict"].items()}}
    (kind, items), = spec.items()           # "list" or "tuple"
    return {kind: [_strip(v) for v in items]}


def _write_atomic(path: str, write) -> None:
    """``write(tmp)`` into a temporary file beside ``path``, then rename
    it into place: a reader sees the old file or the new, never half."""
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path),
                               prefix=f".{os.path.basename(path)}-")
    os.close(fd)
    try:
        write(tmp)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def save(path: str, tree: Any, config=None,
         overwrite: bool = False) -> None:
    """Save ``tree`` (and a dataclass ``config``, as JSON) to the directory
    ``path``.  ``overwrite=True`` replaces an existing checkpoint
    atomically -- the per-chunk pattern of
    benchmarks/montecarlo_100k.py; without it an existing one raises
    FileExistsError."""
    path = os.path.abspath(path)
    target = os.path.join(path, TREE_FILE)
    if os.path.exists(target) and not overwrite:
        raise FileExistsError(f"checkpoint exists: {path}")
    os.makedirs(path, exist_ok=True)
    leaves: list = []
    spec = json.dumps(_flatten(tree, leaves))
    _write_atomic(target, lambda tmp: torch.save(
        {"spec": spec, "leaves": leaves}, tmp))
    if config is not None:
        text = json.dumps(dataclasses.asdict(config), indent=2, default=str)

        def write_config(tmp):
            with open(tmp, "w") as f:
                f.write(text)
        _write_atomic(os.path.join(path, CONFIG_FILE), write_config)


def restore(path: str, like: Any = None,
            device: torch.device | str | None = None) -> Any:
    """The tree saved by ``save`` at ``path``, its tensors on ``device``
    (default: the CPU; numpy arrays stay numpy).  With ``like``, the
    saved tree must have its structure (ValueError otherwise)."""
    data = torch.load(os.path.join(os.path.abspath(path), TREE_FILE),
                      map_location=device, weights_only=True)
    spec = json.loads(data["spec"])
    if like is not None and _strip(_flatten(like, [])) != _strip(spec):
        raise ValueError(f"checkpoint {path} does not have the structure "
                         "of `like`")
    return _unflatten(spec, data["leaves"])


def load_config_dict(path: str) -> dict:
    with open(os.path.join(os.path.abspath(path), CONFIG_FILE)) as f:
        return json.load(f)
