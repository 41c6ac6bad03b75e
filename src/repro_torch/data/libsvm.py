"""LibSVM text-format IO: the port's copy of ``repro/data/libsvm.py``
(that module imports no JAX, but the package around it does, so the port
keeps its own), with the same parse, the same error messages, the same
``rank``/``world`` line striping and the same padded blocks.

The paper's MPI implementation has each process read its own partition of
the data file (Sec 5.6/5.7.1); ``load_libsvm`` supports that pattern via
``rank``/``world`` striping, so host h parses only every world-th line.
Dense output.

``iter_libsvm`` is the out-of-core flavour: it yields fixed-shape padded
row blocks with validity masks, so the data set is never resident at
once. Sigma = X^T diag(1/gamma) X and the mu-numerator are exact sums over
rows (paper Fig. 1), and the solver's ``driver="stream"`` accumulates them
chunk by chunk.
"""
from __future__ import annotations

from typing import Iterator

import numpy as np


def save_libsvm(path: str, X: np.ndarray, y: np.ndarray) -> None:
    with open(path, "w") as f:
        for row, label in zip(X, y):
            nz = np.nonzero(row)[0]
            feats = " ".join(f"{j + 1}:{row[j]:.6g}" for j in nz)
            lab = int(label) if float(label).is_integer() else float(label)
            f.write(f"{lab} {feats}\n")


def parse_libsvm_line(line: str, lineno: int):
    """Parse one libsvm line into (label, {col0: val}) or None.

    Tolerates ``#`` comment suffixes and blank/whitespace-only lines
    (returns None for those). Malformed labels or ``idx:val`` tokens
    raise ValueError naming the line and token, instead of an opaque
    float()/int() error from deep inside a parse loop.
    """
    line = line.split("#", 1)[0].strip()
    if not line:
        return None
    parts = line.split()
    try:
        label = float(parts[0])
    except ValueError:
        raise ValueError(
            f"libsvm parse error at line {lineno}: label {parts[0]!r} "
            "is not a number") from None
    feat = {}
    for tok in parts[1:]:
        idx, sep, val = tok.partition(":")
        try:
            if not sep:
                raise ValueError
            j = int(idx)
            v = float(val)
        except ValueError:
            raise ValueError(
                f"libsvm parse error at line {lineno}: malformed "
                f"'idx:val' token {tok!r}") from None
        if j < 1:
            raise ValueError(
                f"libsvm parse error at line {lineno}: feature index "
                f"{j} out of range (indices are 1-based)")
        feat[j - 1] = v
    return label, feat


def load_libsvm(path: str, n_features: int | None = None,
                rank: int = 0, world: int = 1):
    """Parse a libsvm file; with world > 1, return this rank's row stripe
    (round-robin by line index — the paper's per-process IO split)."""
    rows, labels = [], []
    max_j = 0
    with open(path) as f:
        for i, line in enumerate(f):
            if world > 1 and (i % world) != rank:
                continue
            parsed = parse_libsvm_line(line, i + 1)
            if parsed is None:
                continue
            label, feat = parsed
            labels.append(label)
            if feat:
                max_j = max(max_j, max(feat))
            rows.append(feat)
    K = n_features if n_features is not None else max_j + 1
    X = np.zeros((len(rows), K), np.float32)
    for i, feat in enumerate(rows):
        for j, v in feat.items():
            if j < K:
                X[i, j] = v
    return X, np.asarray(labels, np.float32)


def iter_libsvm(path: str, chunk_rows: int, n_features: int,
                rank: int = 0, world: int = 1,
                ) -> Iterator[tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Stream a libsvm file as fixed-shape padded row blocks.

    Yields ``(X (chunk_rows, n_features) f32, y (chunk_rows,) f32,
    mask (chunk_rows,) f32)``; every block has the same shape (the final
    partial block is zero-padded with ``mask == 0``), so every chunk
    takes one launch plan. Padded rows follow the package's convention:
    X-row = 0, target = 0, mask = 0 — their sufficient
    statistics contributions are exactly zero.

    With ``world > 1``, yields only rank's round-robin line stripe
    (the paper's Sec 5.6 per-process IO split); striping is by raw line
    index so every rank agrees on the split without coordination.

    ``n_features`` is required: a streaming reader cannot discover the
    feature-space width without a full extra pass.
    """
    if chunk_rows < 1:
        raise ValueError(f"chunk_rows must be >= 1, got {chunk_rows}")
    if n_features < 1:
        raise ValueError(f"n_features must be >= 1, got {n_features}")
    X = np.zeros((chunk_rows, n_features), np.float32)
    y = np.zeros((chunk_rows,), np.float32)
    mask = np.zeros((chunk_rows,), np.float32)
    fill = 0
    with open(path) as f:
        for i, line in enumerate(f):
            if world > 1 and (i % world) != rank:
                continue
            parsed = parse_libsvm_line(line, i + 1)
            if parsed is None:
                continue
            label, feat = parsed
            y[fill] = label
            mask[fill] = 1.0
            for j, v in feat.items():
                if j < n_features:
                    X[fill, j] = v
            fill += 1
            if fill == chunk_rows:
                yield X.copy(), y.copy(), mask.copy()
                X[:] = 0.0
                y[:] = 0.0
                mask[:] = 0.0
                fill = 0
    if fill:
        yield X.copy(), y.copy(), mask.copy()
