"""Carry configs, fitted weights, servable models, warm-start donors and
language-model weights across from the JAX package.

Every function takes plain Python and numpy values, never objects of
``repro``, so this module imports nothing of it: a caller passes
``dataclasses.asdict(reference_config)``, ``FitResult.weights``, the
fields of a reference ``ServableModel`` or of a reference ``FitResult``,
or a model's parameters (or a train state) flattened to {leaf path: numpy
array}.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs import ModelConfig
from repro_torch.models import Model, build_model
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


def lm_params_from_reference(cfg_fields: dict, flat: dict, device=None,
                             **model_kw) -> Model:
    """The port's model of the reference config whose
    ``dataclasses.asdict`` is ``cfg_fields``, holding the reference's
    parameters ``flat``: {leaf path: numpy array}, each path as the
    reference's ``tree_flatten_with_path`` names it, joined by "/"
    ("embed/table", "layers/pos0/attn/wq", ...; the port's checkpoint
    flattener names them so). The stacked layout is the reference's, so
    the weights carry across leaf by leaf."""
    fields = {k: tuple(v) if isinstance(v, list) else v
              for k, v in cfg_fields.items()}
    model = build_model(ModelConfig(**fields), device, **model_kw)
    model.load_params(_nest({k: np.array(v, np.float32)
                             for k, v in flat.items()}))
    return model


def _nest(flat: dict) -> dict:
    """{"a/b/c": array} -> {"a": {"b": {"c": tensor}}}."""
    tree: dict = {}
    for path, value in flat.items():
        *parents, leaf = path.split("/")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = torch.from_numpy(np.asarray(value))
    return tree


def train_state_from_reference(cfg_fields: dict, flat: dict, device=None,
                               **model_kw) -> tuple[Model, dict]:
    """The port's model and train state ``{"params", "opt": {"m", "v",
    "step"}}`` from a reference train state flattened to {leaf path: numpy
    array} ("params/embed/table", "opt/m/embed/table", ..., "opt/step",
    as the checkpoint flattener names them). The model holds the
    parameters; the state's parameters are its tensors."""
    groups: dict = {"params": {}, "opt/m": {}, "opt/v": {}}
    step = None
    for path, value in flat.items():
        if path == "opt/step":
            step = torch.tensor(np.asarray(value), dtype=torch.int32)
            continue
        head = next((g for g in groups if path.startswith(g + "/")), None)
        if head is None:
            raise ValueError(f"{path!r} is not a leaf of a train state "
                             "(params/..., opt/m/..., opt/v/..., opt/step)")
        groups[head][path[len(head) + 1:]] = np.array(value, np.float32)
    if step is None:
        raise ValueError("the train state has no opt/step")
    model = lm_params_from_reference(cfg_fields, groups["params"], device,
                                     **model_kw)
    moments = {}
    for g in ("opt/m", "opt/v"):
        if set(groups[g]) != set(groups["params"]):
            raise ValueError(f"{g} and params name different leaves")
        moments[g[-1]] = _to(_nest(groups[g]), model.device)
    return model, {"params": model.params,
                   "opt": {"m": moments["m"], "v": moments["v"],
                           "step": step.to(model.device)}}


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)
