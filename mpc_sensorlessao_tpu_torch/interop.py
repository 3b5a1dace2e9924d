"""Carry the JAX package's built operators across to the port.

The functions take the JAX ``LoopModels`` / ``FrozenFlowLayers`` /
``EdgeFlowModel`` / ``EdgeFlowState`` fields
as numpy arrays, keyed by the JAX field names -- either the JAX objects
after ``jax.tree.map(np.asarray, ...)`` or plain mappings -- and return
the port's objects on ``device``.  With them both engines can run the
same operators, so a parity test holds the control step apart from the
build.  Nothing here imports jax.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Mapping

import numpy as np
import torch

from .models import closed_loop, estimator, mpc
from .ops import edge_flow, newton_kkt, phase_screens


def _get(tree, name):
    return tree[name] if isinstance(tree, Mapping) else getattr(tree, name)


def _tensor(a, device) -> torch.Tensor:
    arr = np.array(a)       # a writable copy
    if np.issubdtype(arr.dtype, np.floating):
        arr = arr.astype(np.float32)
    return torch.as_tensor(arr, device=device)


def _from(cls, tree, device, **given):
    """Instance of dataclass ``cls`` with each field read from ``tree``
    (arrays become tensors) unless ``given``."""
    kw = {}
    for f in dataclasses.fields(cls):
        if not f.init:
            continue
        if f.name in given:
            kw[f.name] = given[f.name]
            continue
        v = _get(tree, f.name)
        kw[f.name] = (_tensor(v, device)
                      if isinstance(v, (np.ndarray, np.generic)) else v)
    return cls(**kw)


def estimator_from_numpy(est, device) -> estimator.EstimatorModel:
    """EstimatorModel from the JAX one; its (2, w, R) real/imag DFT stack
    becomes the port's complex (w, R) operator; ``dft_dtype`` and the
    mmse estimator's ``map_reg`` (or None) carry across."""
    op = np.asarray(_get(est, "dft_op"), dtype=np.float32)
    dft_op = torch.as_tensor((op[0] + 1j * op[1]).astype(np.complex64),
                             device=device)
    return _from(estimator.EstimatorModel, est, device, dft_op=dft_op)


def layers_from_numpy(layers, device) -> phase_screens.FrozenFlowLayers:
    return _from(phase_screens.FrozenFlowLayers, layers, device)


def loop_models_from_numpy(tree, device) -> closed_loop.LoopModels:
    """LoopModels from the JAX ``LoopModels`` fields."""
    return _from(
        closed_loop.LoopModels, tree, device,
        est=estimator_from_numpy(_get(tree, "est"), device),
        mats=_from(mpc.MPCMatrices, _get(tree, "mats"), device),
        prob=_from(newton_kkt.FastMPCProblem, _get(tree, "prob"), device),
        fixed_op=_from(newton_kkt.FixedNewtonOperator,
                       _get(tree, "fixed_op"), device))


def edge_model_from_numpy(model, device) -> edge_flow.EdgeFlowModel:
    """EdgeFlowModel from the JAX one: A and Bc keep their dtype (float32,
    or bfloat16 for edge_op_dtype="bfloat16"), the ring indices become
    int64; the JAX ``shift_select``/``impl`` choices are not carried."""
    def op(name):
        arr = np.asarray(_get(model, name))
        dtype = (torch.bfloat16 if arr.dtype.name == "bfloat16"
                 else torch.float32)
        return torch.as_tensor(arr.astype(np.float32), device=device).to(
            dtype)

    def idx(name):
        return torch.as_tensor(np.asarray(_get(model, name), np.int64),
                               device=device)
    return edge_flow.EdgeFlowModel(
        A=op("A"), Bc=op("Bc"), outer_idx=idx("outer_idx"),
        inner_idx=idx("inner_idx"),
        step_px=tuple(tuple(float(v) for v in s)
                      for s in _get(model, "step_px")),
        nsub=tuple(tuple(int(v) for v in s) for s in _get(model, "nsub")),
        size=int(_get(model, "size")))


def edge_state_from_numpy(state, device) -> edge_flow.EdgeFlowState:
    return _from(edge_flow.EdgeFlowState, state, device)
