"""Sufficient statistics, their reductions and the posterior solve: port of
``repro/core/stats.py``.

The paper's parallel structure (Sec 4.1, Fig. 1): every worker computes

    Sigma^p = sum_d (1/gamma_d) x_d x_d^T        (K x K)
    mu^p    = sum_d (rho_d/gamma_d + beta_d) x_d (K,)

and the global statistics are plain sums over workers: an all-reduce over
the process group of the mesh's data axes (``distributed.MeshAxes``),
the identity without a mesh. Sigma^p is symmetric, so its packed lower
triangle rides one collective with b (``reduce_stats``). The 2-D
(data x k) statistic reduces each rank's column block with b over the data
axes and gathers the blocks over the k axis (``reduce_kshard``). The
M-step is the posterior solve (EM) or the Gaussian draw ``draw_weight``
(MC), replicated on every rank. ``StatsWindow`` is the hard-expiry ring
of per-generation statistics a warm-started stream fit folds in.
"""
from __future__ import annotations

import itertools

import numpy as np
import torch

from . import distributed as cdist
from . import prng


def shard_row_offset(local_n: int, axes) -> int:
    """Global row index of this rank's first row: the rows are laid out
    row-major over the data axes (``distributed.shard_rows``), so it is
    the linear shard index times the local row count; 0 without a mesh.
    The MC draws are keyed by global row, so a mesh fit draws the chain of
    a one-device fit."""
    return 0 if axes is None else axes.index * local_n


def triangle_pack(S: torch.Tensor) -> torch.Tensor:
    """The K(K+1)/2 lower triangle of a symmetric (K, K) matrix, or of
    each matrix of a (C, K, K) stack, row-major."""
    K = S.shape[-1]
    i, j = torch.tril_indices(K, K, device=S.device)
    return S[..., i, j]


def triangle_unpack(packed: torch.Tensor, K: int) -> torch.Tensor:
    """Inverse of ``triangle_pack``: the full symmetric matrix (or
    stack)."""
    i, j = torch.tril_indices(K, K, device=packed.device)
    S = packed.new_zeros(packed.shape[:-1] + (K, K))
    S[..., i, j] = packed
    return S + torch.tril(S, -1).transpose(-1, -2)


def preduce(x: torch.Tensor, axes=None, live=None) -> torch.Tensor:
    """Sum over the data-parallel workers of ``axes``; the identity
    without a mesh.

    ``live`` (this shard's 0-d liveness weight) switches to the failure-
    tolerant reduction sum_p live_p x_p * P / max(sum_p live_p, 1): a dead
    replica (live = 0) drops out and the sum stays an unbiased estimate
    of the full-data sum. At live = 1 everywhere it is bitwise the plain
    sum (x * 1 and * (P / P) are exact). The weight is cast to x's dtype
    (0 and 1 are exact in bfloat16), so a compressed payload stays
    compressed; the denominator is one float32 scalar."""
    if axes is None:
        return x
    if live is None:
        return cdist.all_reduce(x, axes)
    num = cdist.all_reduce(live.to(x.dtype) * x, axes)
    den = cdist.all_reduce(live.to(torch.float32), axes)
    scale = axes.size / torch.clamp_min(den, 1.0)
    return num * scale.to(num.dtype)


def masked_mean(x: torch.Tensor, mask: torch.Tensor, axes=None,
                live=None) -> torch.Tensor:
    """Mean of x over valid rows, reduced over the workers (a diagnostic).
    The ``live`` factors cancel between num and den: after a dropped
    shard it is the mean over the surviving rows."""
    num = preduce(torch.sum(x * mask), axes, live)
    den = preduce(torch.sum(mask), axes, live)
    return num / torch.clamp_min(den, 1.0)


def _dtype(reduce_dtype: str | None):
    return None if reduce_dtype is None else getattr(torch, reduce_dtype)


def reduce_stats(S: torch.Tensor, b: torch.Tensor, axes=None,
                 triangle: bool = True, reduce_dtype: str | None = None,
                 live=None):
    """All-reduce (Sigma^p, mu^p) over the data-parallel workers; the
    identity without a mesh.

    ``triangle`` packs the lower triangle of S with b into one collective
    (K(K+1)/2 + K words instead of K^2 and K in two). A multichain
    statistic, S (C, K, K) and b (K, C), packs every chain's triangle into
    the same collective. ``reduce_dtype='bfloat16'`` sends the payload in
    bfloat16 and restores float32 after the sum: it needs the gamma clamp
    eps >= 1e-3 (at 1e-6 the 1/gamma range exceeds bfloat16's mantissa
    and the posterior collapses, the reference's measured caveat).
    ``live`` as in ``preduce``. The packed triangle is that of
    (S + S^T) / 2, which the posterior solve takes anyway: a one-rank mesh
    is then bitwise the one-device fit (the kernels' diagonal tiles are
    not exactly symmetric)."""
    if axes is None:
        return S, b
    dt = _dtype(reduce_dtype)

    def red(x):
        if dt is None:
            return preduce(x, axes, live)
        return preduce(x.to(dt), axes, live).to(torch.float32)

    if not triangle:
        return red(S), red(b)
    K = S.shape[-1]
    tri = triangle_pack(0.5 * (S + S.transpose(-1, -2)))
    fused = red(torch.cat([tri.reshape(-1), b.reshape(-1)]))
    n = tri.numel()
    return (triangle_unpack(fused[:n].reshape(tri.shape), K),
            fused[n:].reshape(b.shape))


def reduce_kshard(S_blk: torch.Tensor, b: torch.Tensor, axes,
                  k_shard_axis, reduce_dtype: str | None = None,
                  live=None):
    """The 2-D (data x k) reduction: one packed sum of this k-shard's
    (K, blk) Sigma column block and b over the data axes, then an
    all-gather of the blocks over the k axis, laid side by side in k order
    into the full (K, K) Sigma. ``reduce_dtype`` compresses the sum as in
    ``reduce_stats``; the gather stays float32. ``live`` is a data-axis
    weight, the same on every k-shard of a data shard, so every block
    renormalizes by the same factor."""
    K, blk = S_blk.shape
    dt = _dtype(reduce_dtype)
    fused = torch.cat([S_blk.reshape(-1), b])
    if axes is not None:
        fused = (preduce(fused, axes, live) if dt is None else
                 preduce(fused.to(dt), axes, live).to(torch.float32))
    S_blk, b = fused[:K * blk].reshape(K, blk), fused[K * blk:]
    return cdist.all_gather(S_blk, k_shard_axis, 1), b


def posterior_params(S: torch.Tensor, b: torch.Tensor, lam: float,
                     prior_precision: torch.Tensor | None = None,
                     jitter: float = 0.0):
    """(L, mu) of the Gaussian conditional p(w | gamma, D) (Eq. 4/6):
    P = lam*I + S (LIN) or lam*K + S (the exact KRN prior, pass
    ``prior_precision=K``), L its lower Cholesky factor, mu = P^{-1} b.

    ``cholesky_ex`` leaves the error flag on the device; plain
    ``cholesky`` would check it and force a host sync every iteration. A
    failed factorization gives NaN, as the reference's ``cholesky`` does
    (``cholesky_ex`` would hand back a partial factor, and the solve
    finite nonsense).
    """
    K = S.shape[0]
    eye = torch.eye(K, dtype=S.dtype, device=S.device)
    P = S + lam * (eye if prior_precision is None else prior_precision)
    P = 0.5 * (P + P.T)  # exact symmetry for the factorization
    # Relative jitter: fp32 Gram statistics carry O(eps * trace/K)
    # negative eigenvalue noise; scale the ridge to the problem.
    scale = torch.trace(P) / K
    P = P + (jitter * scale) * eye
    L, info = torch.linalg.cholesky_ex(P)
    L = torch.where(info == 0, L, torch.nan)
    mu = torch.cholesky_solve(b[:, None], L)[:, 0]
    return L, mu


def draw_weight(key: torch.Tensor, L: torch.Tensor, mu: torch.Tensor
                ) -> torch.Tensor:
    """MC draw w ~ N(mu, P^{-1}) via w = mu + L^{-T} z (paper Eq. 4), with
    z = ``prng.normal(key, (K,))`` as the reference draws it."""
    z = prng.normal(key, tuple(mu.shape)).to(mu.dtype)
    return mu + torch.linalg.solve_triangular(L.T, z[:, None],
                                              upper=True)[:, 0]


class StatsWindow:
    """Hard-expiry ring of per-generation (Sigma, b) statistic partials:
    the windowed alternative to the geometric ``SVMConfig.decay`` warm
    start.

    Decay folds the previous generation's effective statistics in at
    weight d, so every generation keeps a geometric tail. A window keeps
    the fresh partials of the last ``horizon - 1`` generations as they
    were and sums them at full weight; an older generation is dropped.
    (Sigma, b) are sums over rows, so the drop is exact data expiry.

    ``entries[0]`` is the newest retained previous generation; each entry
    is a dict of "S" and "b" arrays (numpy, or device tensors while a fit
    folds them). The ring is frozen for a whole fit and rides a
    checkpoint as it is (``pack`` / ``unpack``)."""

    def __init__(self, horizon: int, entries=()):
        assert horizon >= 1, horizon
        self.horizon = int(horizon)
        self.entries = [dict(e) for e in entries][: self.horizon - 1]

    def folded(self, fresh: dict) -> dict:
        """The M-step's statistics: fresh + every retained generation at
        full weight, newest first (``fresh + e0 + e1 + ...``: one
        association order, so repeated folds are bitwise the same)."""
        out = dict(fresh)
        for e in self.entries:
            out["S"] = out["S"] + e["S"]
            out["b"] = out["b"] + e["b"]
        return out

    def advance(self, fresh: dict) -> list[dict]:
        """The ring the next generation carries: this generation's fresh
        partials (as numpy) in front, cut to the horizon."""
        head = [{k: _numpy(fresh[k]) for k in ("S", "b")}]
        return (head + self.entries)[: self.horizon - 1]

    @staticmethod
    def pack(entries) -> dict:
        """Flat ``{win{i}_{S,b}: array}`` dict for a checkpoint."""
        return {f"win{i}_{k}": _numpy(e[k])
                for i, e in enumerate(entries) for k in ("S", "b")}

    @staticmethod
    def unpack(arrays: dict) -> list:
        """Inverse of ``pack`` over a flat checkpoint-arrays dict."""
        out: list[dict] = []
        for i in itertools.count():
            if f"win{i}_S" not in arrays:
                break
            out.append({"S": np.asarray(arrays[f"win{i}_S"]),
                        "b": np.asarray(arrays[f"win{i}_b"])})
        return out


def _numpy(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
