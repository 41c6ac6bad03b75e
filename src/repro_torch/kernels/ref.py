"""Plain PyTorch versions of the ported kernels: port of
``repro/kernels/ref.py`` (the hinge epilogues, pre-drawn noise, the
counter seed and multichain; no column window).

They are the CPU path of ``ops`` and the oracles the CUDA kernels are held
against. Inputs are computed in float32, as in the reference; float64
inputs stay float64, which is how ``chip_smoke.py`` evaluates the plain
version exactly. Padded rows (X-row 0, rho = beta = 0) contribute nothing.
"""
from __future__ import annotations

import torch

from . import epilogues


def seed_noise(seed: torch.Tensor, n: int, n_chains: int, epilogue: str):
    """The counter stream the fused kernel derives in-body for ``n`` rows
    from ``seed`` = [k0, k1, row0, chain0]: the epilogue's noise tuple of
    (n,) tensors for one chain, (n, n_chains) for a multichain call."""
    noise = epilogues.fused_noise(seed, 0, (n, n_chains), epilogue)
    return noise if n_chains > 1 else tuple(z[:, 0] for z in noise)


def _acc(t: torch.Tensor) -> torch.Tensor:
    return t if t.dtype == torch.float64 else t.float()


def weighted_gram(X: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """S = X^T diag(w) X, (K, K)."""
    Xf = _acc(X)
    return (Xf * _acc(w)[:, None]).T @ Xf


def syrk_tri(X: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Same function as ``weighted_gram``; the kernel computes only the
    lower-triangle tiles and mirrors them."""
    return weighted_gram(X, w)


def fused_estep(X: torch.Tensor, rho: torch.Tensor, beta: torch.Tensor,
                wvec: torch.Tensor, eps: float):
    """(margin (N,), gamma (N,), b (K,)) for the generic hinge:
    margin = Xw, gamma = max(eps, |rho - margin|),
    b = X^T (rho/gamma + beta)."""
    Xf = _acc(X)
    margin = Xf @ _acc(wvec)
    rho = _acc(rho)
    gamma = (rho - margin).abs().clamp_min(eps)
    coef = rho / gamma + _acc(beta)
    return margin, gamma, Xf.T @ coef


def fused_stats(X: torch.Tensor, rho: torch.Tensor, beta: torch.Tensor,
                wvec: torch.Tensor, wmask: torch.Tensor | None, eps: float,
                epilogue: str = "em_hinge", noise: tuple | None = None,
                seed: torch.Tensor | None = None):
    """(margin, gamma, b, S): the whole iteration statistic with
    S = X^T diag(wmask * weight) X (wmask defaults to ones). MC epilogues
    take pre-drawn ``noise`` or derive it from ``seed`` (``seed_noise``).
    A 2-D (K, C) ``wvec`` (seed required) runs C chains: margin and gamma
    (N, C), b (K, C), S (C, K, K)."""
    Xf = _acc(X)
    if wvec.dim() == 2:
        assert seed is not None, "multichain fused_stats requires seed"
        C = wvec.shape[1]
        margin = Xf @ _acc(wvec)
        noise = seed_noise(seed, X.shape[0], C, epilogue)
        aug, weight, coef = epilogues.apply_epilogue(
            epilogue, margin, _acc(rho)[:, None], _acc(beta)[:, None],
            noise, eps)
        w = weight if wmask is None else _acc(wmask)[:, None] * weight
        S = torch.stack([weighted_gram(X, w[:, c]) for c in range(C)])
        return (margin, *aug, Xf.T @ coef, S)
    if seed is not None:
        noise = seed_noise(seed, X.shape[0], 1, epilogue)
    margin = Xf @ _acc(wvec)
    aug, weight, coef = epilogues.apply_epilogue(
        epilogue, margin, _acc(rho), _acc(beta), noise, eps)
    w = weight if wmask is None else _acc(wmask) * weight
    return (margin, *aug, Xf.T @ coef, weighted_gram(X, w))
