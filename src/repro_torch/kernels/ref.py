"""Plain PyTorch versions of the ported kernels: port of
``repro/kernels/ref.py`` (em_hinge only: no window, seed or multichain).

They are the CPU path of ``ops`` and the oracles the CUDA kernels are held
against. Inputs are computed in float32, as in the reference; float64
inputs stay float64, which is how ``chip_smoke.py`` evaluates the plain
version exactly. Padded rows (X-row 0, rho = beta = 0) contribute nothing.
"""
from __future__ import annotations

import torch

from . import epilogues


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
                epilogue: str = "em_hinge"):
    """(margin, gamma, b, S): the whole iteration statistic with
    S = X^T diag(wmask * weight) X (wmask defaults to ones)."""
    Xf = _acc(X)
    margin = Xf @ _acc(wvec)
    aug, weight, coef = epilogues.apply_epilogue(
        epilogue, margin, _acc(rho), _acc(beta), None, eps)
    w = weight if wmask is None else _acc(wmask) * weight
    return (margin, *aug, Xf.T @ coef, weighted_gram(X, w))
