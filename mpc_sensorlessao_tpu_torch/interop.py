"""Carry the JAX package's built operators across to the port.

The functions take the JAX ``LoopModels`` / ``FrozenFlowLayers`` /
``EdgeFlowModel`` / ``EdgeFlowState`` / ``SHModel`` / ``PyramidModel`` /
``CalibrationVault`` / ``KLBasis`` fields as numpy arrays, keyed by the JAX field names -- either the JAX objects
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

from .models import closed_loop, estimator, integrator, mpc, pyramid, wfs
from .ops import edge_flow, karhunen_loeve, newton_kkt, phase_screens


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


def _complex(ri, device) -> torch.Tensor:
    """A JAX real/imag float32 stack (..., 2, m, n) as one complex64
    tensor (..., m, n)."""
    ri = np.asarray(ri, dtype=np.float32)
    return torch.as_tensor((ri[..., 0, :, :] + 1j * ri[..., 1, :, :])
                           .astype(np.complex64), device=device)


def estimator_from_numpy(est, device) -> estimator.EstimatorModel:
    """EstimatorModel from the JAX one; its (2, w, R) real/imag DFT stack
    becomes the port's complex (w, R) operator; ``dft_dtype`` and the
    mmse estimator's ``map_reg`` (or None) carry across."""
    return _from(estimator.EstimatorModel, est, device,
                 dft_op=_complex(_get(est, "dft_op"), device))


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


def sh_model_from_numpy(sh, device) -> wfs.SHModel:
    """SHModel from the JAX one: its (2, w, n) DFT stack becomes the
    complex (w, n) operator; the valid-subaperture indices are made from
    ``valid``."""
    valid = np.asarray(_get(sh, "valid"), dtype=bool)
    return wfs.SHModel(
        slope_op=_tensor(_get(sh, "slope_op"), device), valid=valid,
        sub_px=int(_get(sh, "sub_px")),
        dft_op=_complex(_get(sh, "dft_op"), device),
        pupil=_tensor(_get(sh, "pupil"), device),
        sel=torch.as_tensor(np.flatnonzero(valid.ravel()), device=device))


def pyramid_model_from_numpy(model, device) -> pyramid.PyramidModel:
    """PyramidModel from the JAX one: the real/imag mask and phasor pairs
    become complex64 tensors (the JAX DFT matrix is not carried: the port
    transforms with torch.fft); the reference slopes and slopes units
    carry across."""
    valid = np.asarray(_get(model, "valid"), dtype=bool)
    return pyramid.PyramidModel(
        pyr_mask=_complex(_get(model, "pyr_mask"), device),
        phasors=_complex(_get(model, "phasors"), device),
        pupil=_tensor(_get(model, "pupil"), device), valid=valid,
        sel=torch.as_tensor(np.flatnonzero(valid.ravel()), device=device),
        reference_slopes=_tensor(_get(model, "reference_slopes"), device),
        slopes_units=float(np.asarray(_get(model, "slopes_units"))),
        resolution=int(_get(model, "resolution")),
        n_lenslet=int(_get(model, "n_lenslet")), c=int(_get(model, "c")))


def vault_from_numpy(vault, device) -> integrator.CalibrationVault:
    return integrator.CalibrationVault(
        M=_tensor(_get(vault, "M"), device),
        singular=np.asarray(_get(vault, "singular"), dtype=np.float64),
        n_thresholded=int(_get(vault, "n_thresholded")))


def kl_basis_from_numpy(kl, device) -> karhunen_loeve.KLBasis:
    stack = _get(kl, "stack")
    return karhunen_loeve.KLBasis(
        to_zernike=_tensor(_get(kl, "to_zernike"), device),
        variances=_tensor(_get(kl, "variances"), device),
        stack=None if stack is None else _tensor(stack, device))
