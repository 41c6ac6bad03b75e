"""Row padding for the one-device drivers: ``pad_rows`` of
``repro/core/distributed.py`` (numpy only). Sharding over several GPUs is
ROADMAP queue 1 item 10."""
from __future__ import annotations

import numpy as np


def pad_rows(X: np.ndarray, target: np.ndarray, shards: int,
             multiple: int = 8):
    """Zero-pad rows to a multiple of (shards * multiple); returns host
    arrays (X, target, mask). Padded rows: X-row = 0, target = 0,
    mask = 0."""
    N = X.shape[0]
    chunk = shards * multiple
    Np = ((N + chunk - 1) // chunk) * chunk
    pad = Np - N
    Xp = np.concatenate([X, np.zeros((pad,) + X.shape[1:], X.dtype)], axis=0)
    tp = np.concatenate([target, np.zeros((pad,), target.dtype)], axis=0)
    mask = np.concatenate([np.ones((N,), np.float32),
                           np.zeros((pad,), np.float32)], axis=0)
    return Xp, tp, mask
