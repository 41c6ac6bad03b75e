"""Synthetic binary datasets: numpy copies of ``repro/data/synthetic.py``
that give arrays bitwise equal to the reference's for the same arguments.

``make_alpha_like`` has the shape of the paper's Table 3 'alpha' set
(250,000 x 500 at full size); ``make_dna_like`` that of its Table 5
'dna' set (wide, sparse-ish 0/1 rows; 25,000,000 x 800 in the paper);
``make_year_like`` the shape of its Table 6
regression set YearPredictionMSD (515,345 x 90); ``make_blobs`` is the
quickstart problem; ``make_circles`` is the kernel (KRN) problem, two
rings no line separates; ``make_mnist8m_like`` the shape of its Table 8
multiclass set mnist8m (10 classes, 784 pixel features);
``make_lm_tokens`` is the token stream of the LM examples.
"""
from __future__ import annotations

import numpy as np


def _blob_classifier(rng, n, k, margin_noise):
    w = rng.normal(size=k) / np.sqrt(k)
    X = rng.normal(size=(n, k)).astype(np.float32)
    logits = X @ w + margin_noise * rng.normal(size=n)
    y = np.where(logits > 0, 1.0, -1.0).astype(np.float32)
    return X, y


def make_alpha_like(n: int = 50_000, k: int = 500, seed: int = 0,
                    margin_noise: float = 0.5):
    """Dense, moderately hard binary problem (Pascal LSL 'alpha' shape)."""
    rng = np.random.default_rng(seed)
    return _blob_classifier(rng, n, k, margin_noise)


def make_dna_like(n: int = 200_000, k: int = 800, seed: int = 1,
                  sparsity: float = 0.25, margin_noise: float = 0.45):
    """'dna'-shaped: wide-ish, sparse-ish binary data. Values in {0,1};
    labels from a planted hyperplane with noise (~90 % achievable
    accuracy, as in the paper's Table 5)."""
    rng = np.random.default_rng(seed)
    X = (rng.random((n, k)) < sparsity).astype(np.float32)
    w = rng.normal(size=k) / np.sqrt(k * sparsity)
    logits = X @ w - np.median(X @ w) + margin_noise * rng.normal(size=n)
    y = np.where(logits > 0, 1.0, -1.0).astype(np.float32)
    return X, y


def make_year_like(n: int = 50_000, k: int = 90, seed: int = 2,
                   noise: float = 0.3):
    """'YearPredictionMSD'-shaped regression; targets normalized to zero
    mean and unit variance, as in the paper's Sec 5.10 protocol."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, k)).astype(np.float32)
    w = rng.normal(size=k) / np.sqrt(k)
    ynorm = X @ w + noise * rng.normal(size=n)
    ynorm = (ynorm - ynorm.mean()) / ynorm.std()
    return X, ynorm.astype(np.float32)


def make_mnist8m_like(n: int = 100_000, k: int = 798, m: int = 10,
                      seed: int = 3, margin_noise: float = 1.0):
    """'mnist8m'-shaped m-class problem: a class-prototype mixture in
    [0, 1] pixel-like features, 8 % of the labels redrawn (accuracy in the
    high 80s, as in Table 8). Labels are int32 class ids."""
    rng = np.random.default_rng(seed)
    protos = rng.random((m, k)).astype(np.float32)
    labels = rng.integers(0, m, size=n).astype(np.int32)
    X = 0.5 * protos[labels] + 0.5 * rng.random((n, k)).astype(np.float32)
    flip = rng.random(n) < 0.08
    labels[flip] = rng.integers(0, m, size=int(flip.sum()))
    del margin_noise
    return X.astype(np.float32), labels


def make_blobs(n: int = 2000, k: int = 20, seed: int = 0,
               margin_noise: float = 0.1):
    """Small generic binary blobs (tests/examples)."""
    rng = np.random.default_rng(seed)
    return _blob_classifier(rng, n, k, margin_noise)


def make_circles(n: int = 400, seed: int = 0):
    """Radially-separated classes, not linearly separable (KRN demo)."""
    rng = np.random.default_rng(seed)
    r = np.concatenate([rng.uniform(0, 1, n // 2),
                        rng.uniform(1.5, 2.5, n - n // 2)])
    th = rng.uniform(0, 2 * np.pi, n)
    X = np.stack([r * np.cos(th), r * np.sin(th)], 1).astype(np.float32)
    y = np.concatenate([np.ones(n // 2), -np.ones(n - n // 2)])
    return X, y.astype(np.float32)


def make_lm_tokens(n_tokens: int, vocab: int, seed: int = 0,
                   motif_len: int = 16, n_motifs: int = 64) -> np.ndarray:
    """Synthetic token stream: Zipfian unigrams + repeated motifs so a
    language model has learnable structure (loss decreases)."""
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    probs = (1.0 / ranks); probs /= probs.sum()
    stream = rng.choice(vocab, size=n_tokens, p=probs).astype(np.int32)
    motifs = rng.choice(vocab, size=(n_motifs, motif_len), p=probs)
    n_insert = n_tokens // (motif_len * 4)
    pos = rng.integers(0, max(1, n_tokens - motif_len), size=n_insert)
    for p in pos:
        stream[p:p + motif_len] = motifs[rng.integers(0, n_motifs)]
    return stream
