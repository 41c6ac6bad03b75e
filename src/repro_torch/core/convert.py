"""Carry configs, fitted weights, servable models and warm-start donors
across from the JAX package.

Every function takes plain Python and numpy values, never objects of
``repro``, so this module imports nothing of it: a caller passes
``dataclasses.asdict(reference_config)``, ``FitResult.weights``, the
fields of a reference ``ServableModel`` or of a reference ``FitResult``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.runtime.policy import FaultPolicy
from repro_torch.serving import ServableModel

from .nystrom import NystromSVM
from .solver import FitResult, PEMSVM, SVMConfig

_FIELDS = tuple(f.name for f in dataclasses.fields(SVMConfig))


def config_from_reference(fields: dict) -> SVMConfig:
    """The port's SVMConfig with the same field values as the reference
    config whose ``dataclasses.asdict`` is ``fields``, the mesh fields
    (``k_shard_axis``, ``pad_features``, ``triangle_reduce``,
    ``reduce_dtype``) and the fault policy included. The reference's
    kernel backends ('interpret', 'pallas') map to the port's default
    (the kernels on a CUDA tensor, the plain path on a CPU tensor)."""
    unknown = sorted(set(fields) - set(_FIELDS))
    if unknown:
        raise ValueError(f"fields unknown to SVMConfig: {unknown}")
    fields = dict(fields)
    if fields.get("backend") in ("interpret", "pallas"):
        fields["backend"] = None
    if isinstance(fields.get("fault"), dict):
        fields["fault"] = FaultPolicy(**fields["fault"])
    return SVMConfig(**fields)


def svm_from_reference(config: SVMConfig, weights: np.ndarray,
                       n_features: int, device=None,
                       train_X: np.ndarray | None = None) -> PEMSVM:
    """A fitted port model from a reference fit's ``FitResult.weights``:
    its decision_function / predict / score (and rmse for SVR) give the
    reference model's results. ``n_features`` is the raw width D of a
    request row. A LIN model takes (K,) weights, or (M, K) for MLT, with
    K = D + add_bias; an exact KRN model takes its dual weights (N_pad,)
    and its (N, D) training rows ``train_X`` (the reference's
    ``_train_X``), N <= N_pad."""
    w = np.asarray(weights, np.float32)
    if config.formulation == "KRN":
        if train_X is None:
            raise ValueError("an exact KRN model needs its training rows "
                             "(train_X)")
        train_X = np.asarray(train_X, np.float32)
        if (train_X.ndim != 2 or train_X.shape[1] != n_features
                or w.ndim != 1 or w.shape[0] < train_X.shape[0]):
            raise ValueError(
                f"dual weights of shape {w.shape} and training rows of "
                f"shape {train_X.shape}; a KRN model of {n_features} "
                "features needs (N_pad,) weights with N_pad >= N and "
                f"(N, {n_features}) rows")
    else:
        K = n_features + int(config.add_bias)
        want = (config.num_classes, K) if config.task == "MLT" else (K,)
        if w.shape != want:
            raise ValueError(f"weights of shape {w.shape}; a LIN "
                             f"{config.task} model of {n_features} "
                             f"features needs {want}")
    svm = PEMSVM(config, device=device)
    svm._weights = torch.tensor(w, device=svm.device)
    svm._n_features = n_features
    if train_X is not None:
        svm._train_X = torch.tensor(train_X, device=svm.device)
    return svm


def nystrom_from_reference(fields: dict, landmarks: np.ndarray,
                           proj: np.ndarray, weights: np.ndarray,
                           device=None, **kw) -> NystromSVM:
    """A fitted port NystromSVM from a reference one: its KRN config's
    ``dataclasses.asdict`` (``fields``), its featurizer (``_landmarks``
    (m, D), ``_proj`` (m, P)) and ``FitResult.weights`` (P + 1,), or
    (M, P + 1) for MLT, all numpy. ``kw`` goes to NystromSVM (``seed``,
    ``spectral_floor``)."""
    landmarks = np.asarray(landmarks, np.float32)
    proj = np.asarray(proj, np.float32)
    w = np.asarray(weights, np.float32)
    config = config_from_reference(fields)
    width = proj.shape[1] + 1
    want = ((config.num_classes, width) if config.task == "MLT"
            else (width,))
    if w.shape != want:
        raise ValueError(f"weights of shape {w.shape}; a Nystrom "
                         f"{config.task} model with a {proj.shape} "
                         f"projection needs {want}")
    ny = NystromSVM(config, n_landmarks=landmarks.shape[0], device=device,
                    **kw)
    ny._install_featurizer(landmarks, proj)
    ny.svm._weights = torch.tensor(w, device=ny.svm.device)
    ny.svm._n_features = landmarks.shape[1]
    return ny


_SERVABLE_FIELDS = tuple(f.name for f in dataclasses.fields(ServableModel))


def servable_from_reference(fields: dict) -> ServableModel:
    """The port's ServableModel with the field values of a reference one
    (``{f: getattr(model, f)}`` over its dataclass fields, arrays as
    numpy). The reference's kernel backends ('interpret', 'pallas') map
    to the port's default, as in ``config_from_reference``."""
    unknown = sorted(set(fields) - set(_SERVABLE_FIELDS))
    if unknown:
        raise ValueError(f"fields unknown to ServableModel: {unknown}")
    fields = dict(fields)
    if fields.get("backend") in ("interpret", "pallas"):
        fields["backend"] = None
    for k in ("weights", "landmarks", "proj"):
        if fields.get(k) is not None:
            fields[k] = np.array(fields[k], np.float32)
    return ServableModel(**fields)


def fit_result_from_reference(last_sample: np.ndarray,
                              stats: dict | None = None,
                              stats_window: list | None = None,
                              weights: np.ndarray | None = None
                              ) -> FitResult:
    """A warm-start donor for the port from a reference fit's
    ``FitResult.last_sample``, ``stats`` and ``stats_window`` (numpy):
    ``fit(warm_start=...)`` reads exactly these. ``weights`` defaults to
    the last sample."""
    last = np.array(last_sample, np.float32)
    return FitResult(
        weights=last.copy() if weights is None
        else np.array(weights, np.float32),
        last_sample=last, objective=[], aux_history={}, n_iters=0,
        converged=False,
        stats=None if stats is None else {
            k: np.array(v) for k, v in stats.items()},
        stats_window=None if stats_window is None else [
            {k: np.array(v) for k, v in e.items()} for e in stats_window])
