"""Carry configs and fitted weights across from the JAX package.

Both take plain Python and numpy values, never objects of ``repro``, so
this module imports nothing of it: a caller passes
``dataclasses.asdict(reference_config)`` and ``FitResult.weights``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .nystrom import NystromSVM
from .solver import PEMSVM, SVMConfig

_FIELDS = tuple(f.name for f in dataclasses.fields(SVMConfig))


def config_from_reference(fields: dict) -> SVMConfig:
    """The port's SVMConfig with the same field values as the reference
    config whose ``dataclasses.asdict`` is ``fields``, the mesh fields
    (``k_shard_axis``, ``pad_features``, ``triangle_reduce``,
    ``reduce_dtype``) included. The reference's kernel backends
    ('interpret', 'pallas') map to the port's default (the kernels on a
    CUDA tensor, the plain path on a CPU tensor)."""
    unknown = sorted(set(fields) - set(_FIELDS))
    if unknown:
        raise ValueError(f"fields unknown to SVMConfig: {unknown}")
    fields = dict(fields)
    if fields.get("backend") in ("interpret", "pallas"):
        fields["backend"] = None
    return SVMConfig(**fields)


def svm_from_reference(config: SVMConfig, weights: np.ndarray,
                       n_features: int, device=None) -> PEMSVM:
    """A fitted port model from a reference fit's ``FitResult.weights``
    (a LIN CLS or SVR fit): its decision_function / predict / score (and
    rmse for SVR) give the reference model's results. ``n_features`` is the raw width D of a request row."""
    w = np.asarray(weights, np.float32)
    want = n_features + int(config.add_bias)
    if w.shape != (want,):
        raise ValueError(f"weights of shape {w.shape}; a LIN model of "
                         f"{n_features} features needs ({want},)")
    svm = PEMSVM(config, device=device)
    svm._weights = torch.tensor(w, device=svm.device)
    svm._n_features = n_features
    return svm


def nystrom_from_reference(fields: dict, landmarks: np.ndarray,
                           proj: np.ndarray, weights: np.ndarray,
                           device=None, **kw) -> NystromSVM:
    """A fitted port NystromSVM from a reference one: its KRN config's
    ``dataclasses.asdict`` (``fields``), its featurizer (``_landmarks``
    (m, D), ``_proj`` (m, P)) and ``FitResult.weights`` (P + 1,), all
    numpy. ``kw`` goes to NystromSVM (``seed``, ``spectral_floor``)."""
    landmarks = np.asarray(landmarks, np.float32)
    proj = np.asarray(proj, np.float32)
    w = np.asarray(weights, np.float32)
    if w.shape != (proj.shape[1] + 1,):
        raise ValueError(f"weights of shape {w.shape}; a Nystrom model with "
                         f"a ({proj.shape}) projection needs "
                         f"({proj.shape[1] + 1},)")
    ny = NystromSVM(config_from_reference(fields),
                    n_landmarks=landmarks.shape[0], device=device, **kw)
    ny._install_featurizer(landmarks, proj)
    ny.svm._weights = torch.tensor(w, device=ny.svm.device)
    ny.svm._n_features = landmarks.shape[1]
    return ny
