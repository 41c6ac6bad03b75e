"""Host-side data preparation: the port's copy of ``pad_features_to`` from
``repro/data/pipeline.py`` (that module imports jax, so the port keeps its
own). The rest of the pipeline (prefetch, retries, reservoir landmarks)
is ROADMAP queue 1 item 8."""
from __future__ import annotations

import numpy as np


def pad_features_to(X: np.ndarray, multiple: int | None) -> np.ndarray:
    """Zero-pad the feature (last) dimension of a host row block so that its
    width divides ``multiple``: the route to a k_shard-divisible statistic
    width (``linear._k_block`` refuses an indivisible one rather than drop
    Sigma columns; ``SVMConfig.pad_features`` applies this in ``fit`` and
    ``predict``). Zero columns are exact no-ops for every statistic: their
    Sigma rows and columns and b entries are zero and the ridge pins their
    weights to 0. An already divisible width is returned as it is. (The
    reference's ``width=`` mode, for serving, waits for ROADMAP item 12.)"""
    if multiple is None or multiple <= 1:
        return X
    pad = (-X.shape[-1]) % multiple
    if pad == 0:
        return X
    return np.pad(X, [(0, 0)] * (X.ndim - 1) + [(0, pad)])
