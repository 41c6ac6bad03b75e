"""LIN-EM-CLS: linear binary SVM via data augmentation (paper Sec 2, 4).
Port of the EM part of ``repro/core/linear.py``.

One iteration over the training set:

  E-step   gamma_d from the residual y_d - w^T x_d      O(NK)
  stats    Sigma = X^T diag(1/gamma) X                  O(NK^2)  <- kernel
           mu    = X^T (y (1 + 1/gamma))                O(NK)    <- fused
  M-step   Cholesky solve                               O(K^3)

Padding convention: invalid rows have X-row == 0 and target == 0, which
makes their statistics contributions exactly zero; ``mask`` only enters
the objective.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import ops
from . import objective, stats


class SVMData(NamedTuple):
    """The training set as device tensors."""
    X: torch.Tensor       # (N, K) rows zeroed where mask == 0
    target: torch.Tensor  # y in {+-1}; 0 if padded
    mask: torch.Tensor    # (N,) 1.0 valid / 0.0 padding


def accumulate_stats(X: torch.Tensor, rho: torch.Tensor, beta: torch.Tensor,
                     w: torch.Tensor, *, mode: str, eps: float,
                     backend: str | None):
    """(margin, gamma, Sigma, mu) for the generic hinge over a row block,
    in one X pass through ``ops.fused_stats`` with the em_hinge epilogue.
    Shared by CLS (rho = beta = y)."""
    if mode != "EM":
        raise NotImplementedError(
            "MC statistics are not ported yet: ROADMAP queue 1 item 5 "
            "(LIN-MC-CLS)")
    margin, gamma, b, S = ops.fused_stats(X, rho, beta, w, None, None,
                                          epilogue="em_hinge", eps=eps,
                                          backend=backend)
    return margin, gamma, S, b


def cls_step(data: SVMData, w: torch.Tensor, *, lam: float = 1.0,
             eps: float = 1e-6, jitter: float = 1e-6,
             backend: str | None = None):
    """One LIN-EM-CLS iteration. Returns (w_new, aux dict of 0-d device
    tensors); nothing in it waits for the device."""
    X, y, mask = data
    margin, gamma, S, b = accumulate_stats(X, y, y, w, mode="EM", eps=eps,
                                           backend=backend)
    S, b = stats.reduce_stats(S, b)
    _, w_new = stats.posterior_params(S, b, lam, jitter=jitter)
    obj = objective.l2_reg(w_new, lam) + stats.preduce(
        objective.hinge_obj_terms(margin, y, mask))
    n_sv = stats.preduce(torch.sum(mask * (gamma <= 2.0 * eps)))
    return w_new, {"objective": obj,
                   "gamma_mean": stats.masked_mean(gamma, mask),
                   "n_sv": n_sv}


def decision_function(w: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    return X.to(torch.float32) @ w.to(torch.float32)


def init_weight(K: int, device: torch.device | str = "cpu") -> torch.Tensor:
    return torch.zeros((K,), dtype=torch.float32, device=device)
