"""LIN-{EM,MC}-CLS: linear binary SVM via data augmentation (paper Sec 2,
4). Port of ``repro/core/linear.py``.

One iteration over a local row block (other blocks live on other ranks of
the mesh; the reductions go through ``stats.reduce_stats``):

  E-step   gamma_d from the residual y_d - w^T x_d      O(NK/P)
  stats    Sigma^p = X^T diag(1/gamma) X                O(NK^2/P) <- kernel
           mu^p    = X^T (y (1 + 1/gamma))              O(NK/P)   <- fused
  reduce   sum over the data axes                       collective
  M-step   Cholesky solve (EM) / Gaussian draw (MC)     O(K^3), replicated

Padding convention: invalid rows have X-row == 0 and target == 0, which
makes their statistics contributions exactly zero; ``mask`` only enters
the objective. In Nystrom phi-space (``phi_spec``) the statistic
featurizes raw rows on the device, and there the mask is what zeroes
padded rows: a zero X row is not a zero phi row.

``k_shard_axis``: the 2-D (data x k) statistic. Each rank of the k axis
computes only its Sigma column block, inside the one-pass statistic
(``col_window`` of ``ops.fused_stats`` / ``ops.nystrom_fused_stats``);
the blocks ride one packed sum with b over the data axes and are gathered
over the k axis (``stats.reduce_kshard``).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch.kernels import ops
from . import augment, objective, prng, stats


class SVMData(NamedTuple):
    """The training set as device tensors."""
    X: torch.Tensor       # (N, K) rows zeroed where mask == 0
    target: torch.Tensor  # y in {+-1}; 0 if padded
    mask: torch.Tensor    # (N,) 1.0 valid / 0.0 padding


@dataclasses.dataclass(frozen=True)
class PhiSpec:
    """Static half of a Nystrom feature map (``core/nystrom.py``).

    The array half, the (m, D) landmark strip and the (m, m) projection
    K_mm^{-1/2}, travels separately as the ``phi`` operand pair, so that
    SVMConfig stays hashable. With a PhiSpec the statistic featurizes raw
    D-wide rows on the device, and the state width is
    ``proj.shape[1] + add_bias``; ``add_bias`` appends the phi-space bias
    column (mask-valued, so padding stays a no-op), and the X-space
    ``SVMConfig.add_bias`` must be False.
    """
    sigma: float = 1.0
    kind: str = "rbf"
    add_bias: bool = True


def accumulate_stats(X: torch.Tensor, rho: torch.Tensor, beta: torch.Tensor,
                     w: torch.Tensor, *, mode: str,
                     key: torch.Tensor | None, eps: float,
                     backend: str | None, row0: int = 0, rng: str = "host",
                     chain0: int = 0, phi=None,
                     phi_spec: PhiSpec | None = None,
                     mask: torch.Tensor | None = None,
                     col_window: tuple | None = None):
    """(margin, gamma, Sigma, mu) for the generic hinge over a row block,
    in one X pass through ``ops.fused_stats``. Shared by CLS
    (rho = beta = y). ``col_window = (start, blk)`` narrows Sigma to its
    column block (X columns, or phi columns in phi-space): the statistic
    of one k-shard; margin, gamma and mu stay full width.

    EM runs the em_hinge epilogue. MC runs mc_hinge with its noise from
    ``rng``: 'host' pre-draws the fold_in-keyed (nu, u)
    (``augment.draw_ig_noise``); 'fused' passes the (4,) counter seed and
    the kernel derives the noise in-body; 'fused_predraw' materializes
    the same counter stream and passes it as operands (the oracle of
    'fused'). ``row0`` is the block's global row offset and ``chain0``
    the counter's first chain; a 2-D (K, C) ``w`` under 'fused' runs C
    chains (margin and gamma (N, C), b (K, C), Sigma (C, K, K)).

    ``phi`` = (landmarks, proj) with ``phi_spec`` switches to Nystrom
    phi-space: X holds raw rows and ``ops.nystrom_fused_stats``
    featurizes them inside the statistic. ``mask`` (None: all ones)
    zeroes padded phi rows there."""
    if mode == "EM":
        epilogue, noise, seed = "em_hinge", None, None
    elif rng == "host":
        epilogue, seed = "mc_hinge", None
        noise = augment.draw_ig_noise(key, X.shape[0], row0)
    elif rng == "fused_predraw":
        epilogue, seed = "mc_hinge", None
        noise = augment.draw_fused_noise(key, X.shape[0], row0, chain0, 2)
    else:
        assert rng == "fused", rng
        epilogue, noise = "mc_hinge", None
        seed = augment.pack_seed(key, row0, chain0)
    if phi_spec is not None:
        landmarks, proj = phi
        margin, gamma, b, S = ops.nystrom_fused_stats(
            X, landmarks, proj, rho, beta, w, mask, noise,
            sigma=phi_spec.sigma, kind=phi_spec.kind,
            add_bias=phi_spec.add_bias, epilogue=epilogue, eps=eps,
            col_window=col_window, seed=seed, backend=backend)
    else:
        margin, gamma, b, S = ops.fused_stats(
            X, rho, beta, w, None, noise, epilogue=epilogue, eps=eps,
            col_window=col_window, seed=seed, backend=backend)
    return margin, gamma, S, b


def _k_block(width: int, k_axis) -> tuple[int, int]:
    """(start, blk): this k-shard's Sigma column window of the width-K
    statistic (X columns for LIN, the phi width in phi-space). The k axis
    must divide K: truncating to K // n would drop the trailing K % n
    Sigma columns and corrupt the posterior."""
    n = k_axis.size
    if width % n != 0:
        name = k_axis.names[0]
        raise ValueError(
            f"k_shard_axis {name!r} of size {n} does not divide "
            f"K={width}; pad the feature dimension to a multiple of "
            f"{n} with explicit zero columns "
            f"(data.pipeline.pad_features_to / SVMConfig.pad_features) "
            f"or drop k_shard_axis.")
    blk = width // n
    return k_axis.index * blk, blk


def _reduce(S, b, axes, k_shard_axis, triangle, reduce_dtype, live):
    """The step's reduction of (Sigma^p, mu^p): the packed all-reduce over
    the data axes, or under a k axis the 2-D ``reduce_kshard``."""
    if k_shard_axis is None:
        return stats.reduce_stats(S, b, axes, triangle=triangle,
                                  reduce_dtype=reduce_dtype, live=live)
    return stats.reduce_kshard(S, b, axes, k_shard_axis,
                               reduce_dtype=reduce_dtype, live=live)


def chain_keys(key: torch.Tensor, chain0: int, n_chains: int
               ) -> torch.Tensor:
    """Per-chain weight-draw keys ``fold_in(key, chain0 + c)``, (C, 2).
    Under the counter rng modes every weight draw is chain-keyed (even at
    n_chains = 1), so chain c's draw depends only on (iteration key,
    absolute chain id)."""
    ids = chain0 + torch.arange(n_chains, dtype=torch.int64,
                                device=key.device)
    return prng.fold_in(key, ids)


def multichain_draw(key: torch.Tensor, S: torch.Tensor, b: torch.Tensor,
                    lam: float, jitter: float, chain0: int) -> torch.Tensor:
    """Per-chain posterior solves and chain-keyed Gibbs weight draws:
    ``S`` (C, K, K), ``b`` (K, C) -> (C, K)."""
    keys = chain_keys(key, chain0, S.shape[0])
    draws = []
    for c in range(S.shape[0]):
        L, mu = stats.posterior_params(S[c], b[:, c], lam, jitter=jitter)
        draws.append(stats.draw_weight(keys[c], L, mu))
    return torch.stack(draws)


def cls_step(data: SVMData, w: torch.Tensor, key: torch.Tensor | None = None,
             *, mode: str = "EM", lam: float = 1.0, eps: float = 1e-6,
             jitter: float = 1e-6, backend: str | None = None,
             rng: str = "host", n_chains: int = 1, chain0: int = 0,
             phi=None, phi_spec: PhiSpec | None = None, axes=None,
             triangle: bool = True, k_shard_axis=None,
             reduce_dtype: str | None = None, live=None):
    """One LIN-*-CLS iteration. Returns (w_new, aux dict of 0-d device
    tensors); nothing in it waits for the device but the collectives.
    ``n_chains > 1`` (rng='fused') carries the state chain-major as (C, K)
    and reports cross-chain means. ``phi``/``phi_spec`` run it in Nystrom
    phi-space (see ``accumulate_stats``).

    On a mesh, ``axes`` (``distributed.MeshAxes`` of the data axes) sums
    the statistics over the workers, ``k_shard_axis`` (the k axis's
    MeshAxes) gives each rank one Sigma column block, ``triangle`` and
    ``reduce_dtype`` shape the collective, and ``live`` (this shard's 0-d
    liveness weight) renormalizes every reduction around dropped shards;
    all-ones is bitwise the plain sum. The MC draws are keyed by global
    row (``stats.shard_row_offset``): a mesh fit draws the chain of a
    one-device fit."""
    X, y, mask = data
    multi = n_chains > 1
    row0 = stats.shard_row_offset(X.shape[0], axes)
    col_window = (None if k_shard_axis is None
                  else _k_block(w.shape[-1], k_shard_axis))
    margin, gamma, S, b = accumulate_stats(
        X, y, y, w.T if multi else w, mode=mode, key=key, eps=eps,
        backend=backend, row0=row0, rng=rng, chain0=chain0, phi=phi,
        phi_spec=phi_spec, mask=mask, col_window=col_window)
    S, b = _reduce(S, b, axes, k_shard_axis, triangle, reduce_dtype, live)
    if multi:
        w_new = multichain_draw(key, S, b, lam, jitter, chain0)
        maskc = mask[:, None].expand_as(margin)
        obj = objective.l2_reg(w_new, lam) / n_chains + stats.preduce(
            objective.hinge_obj_terms(margin, y[:, None], maskc), axes,
            live) / n_chains
        n_sv = stats.preduce(torch.sum(maskc * (gamma <= 2.0 * eps)), axes,
                             live) / n_chains
        gamma_mean = stats.masked_mean(gamma, maskc, axes, live)
    else:
        L, mu = stats.posterior_params(S, b, lam, jitter=jitter)
        if mode == "EM":
            w_new = mu
        elif rng == "host":
            w_new = stats.draw_weight(key, L, mu)
        else:
            w_new = stats.draw_weight(chain_keys(key, chain0, 1)[0], L, mu)
        obj = objective.l2_reg(w_new, lam) + stats.preduce(
            objective.hinge_obj_terms(margin, y, mask), axes, live)
        n_sv = stats.preduce(torch.sum(mask * (gamma <= 2.0 * eps)), axes,
                             live)
        gamma_mean = stats.masked_mean(gamma, mask, axes, live)
    return w_new, {"objective": obj, "gamma_mean": gamma_mean,
                   "n_sv": n_sv}


def cls_chunk_stats(chunk: SVMData, w: torch.Tensor,
                    key: torch.Tensor | None, row0: int, *, mode: str,
                    eps: float, backend: str | None, phi=None,
                    phi_spec: PhiSpec | None = None, rng: str = "host",
                    n_chains: int = 1, chain0: int = 0) -> dict:
    """The stream driver's E-step body for CLS: one chunk's additive
    contributions, device tensors. Every field is an exact sum over the
    chunk's valid rows, so the driver sums these dicts over the chunks and
    lands on the (Sigma, b, loss, diagnostics) of the in-memory step
    (padded rows contribute zero: a zero X row, or in phi-space the
    mask). ``row0`` is the chunk's global row, which keys the MC draws,
    so the chain does not depend on the chunking. Multichain chunks carry
    S (C, K, K), b (K, C) and chain-mean diagnostics."""
    X, y, mask = chunk
    multi = n_chains > 1
    margin, gamma, S, b = accumulate_stats(
        X, y, y, w.T if multi else w, mode=mode, key=key, eps=eps,
        backend=backend, row0=row0, rng=rng, chain0=chain0, phi=phi,
        phi_spec=phi_spec, mask=mask)
    if multi:
        maskc = mask[:, None].expand_as(margin)
        return {"S": S, "b": b,
                "loss": objective.hinge_obj_terms(margin, y[:, None],
                                                  maskc) / n_chains,
                "gamma_sum": torch.sum(gamma * maskc) / n_chains,
                "mask_sum": torch.sum(mask),
                "n_sv": torch.sum(maskc * (gamma <= 2.0 * eps)) / n_chains}
    return {"S": S, "b": b,
            "loss": objective.hinge_obj_terms(margin, y, mask),
            "gamma_sum": torch.sum(gamma * mask),
            "mask_sum": torch.sum(mask),
            "n_sv": torch.sum(mask * (gamma <= 2.0 * eps))}


def decision_function(w: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    return X.to(torch.float32) @ w.to(torch.float32)


def init_weight(K: int, device: torch.device | str = "cpu",
                n_chains: int = 1) -> torch.Tensor:
    shape = (n_chains, K) if n_chains > 1 else (K,)
    return torch.zeros(shape, dtype=torch.float32, device=device)
