"""Carry the JAX package's built operators across to the port.

The functions take the JAX ``LoopModels`` / ``FrozenFlowLayers`` /
``EdgeFlowModel`` / ``EdgeFlowState`` / ``SHModel`` / ``PyramidModel`` /
``CalibrationVault`` / ``KLBasis`` / ``TBTOperator`` / ``SlopesMMSE`` /
``SlopesTomography`` / ``LGSSlopesMMSE`` / ``LGSModel`` /
``ModalTomography`` / ``ModalMCAO`` fields as numpy arrays, keyed by the JAX field names -- either the JAX objects
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

from .models import closed_loop, estimator, integrator, lgs, mcao, mpc
from .models import pyramid, slopes_mmse, tomography, wfs
from .ops import edge_flow, karhunen_loeve, newton_kkt, phase_screens
from .ops import toeplitz


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


def tbt_from_numpy(op, device) -> toeplitz.TBTOperator:
    return toeplitz.build(tuple(int(v) for v in _get(op, "n_block")),
                          tuple(int(v) for v in _get(op, "n_inner")),
                          np.asarray(_get(op, "gen")), device)


def _tbts(ops, device):
    """Nested tuples of JAX TBTOperators -> the same tuples of the
    port's."""
    if isinstance(ops, (tuple, list)):
        return tuple(_tbts(o, device) for o in ops)
    return tbt_from_numpy(ops, device)


def _valid_fields(model, device) -> dict:
    return dict(noise_var=float(np.asarray(_get(model, "noise_var"))),
                n_lenslet=int(_get(model, "n_lenslet")),
                **slopes_mmse._valid_fields(_get(model, "valid"), device))


def slopes_mmse_from_numpy(model, device) -> slopes_mmse.SlopesMMSE:
    """SlopesMMSE from the JAX one (the valid-lenslet indices and mask
    are made from ``valid``)."""
    return slopes_mmse.SlopesMMSE(
        **{k: tbt_from_numpy(_get(model, k), device)
           for k in ("cxx", "cyy", "cxy", "cox", "coy")},
        **_valid_fields(model, device))


def slopes_tomography_from_numpy(model,
                                 device) -> slopes_mmse.SlopesTomography:
    return slopes_mmse.SlopesTomography(
        cxx_blocks=_tbts(_get(model, "cxx_blocks"), device),
        cxx_blocks_t=_tbts(_get(model, "cxx_blocks_t"), device),
        cox_blocks=_tbts(_get(model, "cox_blocks"), device),
        n_gs=int(_get(model, "n_gs")), **_valid_fields(model, device))


def lgs_slopes_mmse_from_numpy(model,
                               device) -> slopes_mmse.LGSSlopesMMSE:
    return slopes_mmse.LGSSlopesMMSE(
        **{k: tbt_from_numpy(_get(model, k), device)
           for k in ("cxx", "cyy", "cxy")},
        cox_layers=_tbts(_get(model, "cox_layers"), device),
        interp=tuple(_tensor(B, device) for B in _get(model, "interp")),
        **_valid_fields(model, device))


def lgs_model_from_numpy(model, device) -> lgs.LGSModel:
    return lgs.LGSModel(
        heights=_tensor(_get(model, "heights"), device),
        weights=_tensor(_get(model, "weights"), device),
        n_photon=float(np.asarray(_get(model, "n_photon"))),
        launch=_tensor(_get(model, "launch"), device),
        mean_altitude=float(np.asarray(_get(model, "mean_altitude"))))


def tomography_from_numpy(model, device) -> tomography.ModalTomography:
    return tomography.ModalTomography(
        gain=_tensor(_get(model, "gain"), device),
        err_cov=np.asarray(_get(model, "err_cov"), dtype=np.float64),
        err_var_rad2=float(np.asarray(_get(model, "err_var_rad2"))),
        strehl_marechal=float(np.asarray(_get(model, "strehl_marechal"))))


def mcao_from_numpy(model, device) -> mcao.ModalMCAO:
    return mcao.ModalMCAO(
        command=_tensor(_get(model, "command"), device),
        proj=tuple(_tensor(P, device) for P in _get(model, "proj")),
        scao_var_rad2=float(np.asarray(_get(model, "scao_var_rad2"))),
        mcao_var_rad2=float(np.asarray(_get(model, "mcao_var_rad2"))),
        target_vars_rad2=np.asarray(_get(model, "target_vars_rad2"),
                                    dtype=np.float64),
        piston_free_var_rad2=float(np.asarray(
            _get(model, "piston_free_var_rad2"))))
