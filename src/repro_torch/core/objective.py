"""Objectives and metrics of every task (CLS, MLT, SVR; LIN and the exact
KRN prior): port of ``repro/core/objective.py``.

The paper's stopping rule (Sec 5.5) monitors the regularized-risk
objective each iteration and stops when its change falls to tol*N.
Padding rows carry mask 0 and contribute nothing.
"""
from __future__ import annotations

import torch


def hinge_obj_terms(margins: torch.Tensor, y: torch.Tensor,
                    mask: torch.Tensor) -> torch.Tensor:
    """sum_d 2*max(0, 1 - y_d m_d) over valid rows (paper Eq. 1 loss)."""
    return torch.sum(mask * 2.0 * torch.clamp_min(1.0 - y * margins, 0.0))


def svr_obj_terms(pred: torch.Tensor, y: torch.Tensor, eps_ins: float,
                  mask: torch.Tensor) -> torch.Tensor:
    """sum_d 2*max(0, |y_d - f_d| - eps) over valid rows (paper Eq. 20
    loss)."""
    return torch.sum(mask * 2.0 * torch.clamp_min(
        torch.abs(y - pred) - eps_ins, 0.0))


def cs_obj_terms(scores: torch.Tensor, labels: torch.Tensor,
                 mask: torch.Tensor) -> torch.Tensor:
    """Crammer-Singer loss sum_d 2*max_y(Delta_d(y) - Delta f_d(y)) over
    valid rows (paper Eq. 30). scores (N, M) f_d(y), labels (N,) integer
    class ids, Delta the 0/1 cost."""
    M = scores.shape[1]
    onehot = torch.eye(M, dtype=scores.dtype,
                       device=scores.device)[labels.long()]
    delta = 1.0 - onehot
    true_score = torch.sum(scores * onehot, dim=1)
    worst = torch.amax(scores + delta, dim=1)
    return torch.sum(mask * 2.0 * torch.clamp_min(worst - true_score, 0.0))


def l2_reg(w: torch.Tensor, lam: float) -> torch.Tensor:
    """0.5 * lam * ||w||_2^2 (a multiclass W flattens)."""
    return 0.5 * lam * torch.sum(torch.square(w))


def kernel_reg(omega: torch.Tensor, K_omega: torch.Tensor,
               lam: float) -> torch.Tensor:
    """0.5 * lam * omega^T K omega (paper Eq. 15), from the product
    K omega the caller has already formed."""
    return 0.5 * lam * torch.dot(omega, K_omega)


def accuracy(pred_labels: torch.Tensor, labels: torch.Tensor,
             mask: torch.Tensor | None = None) -> torch.Tensor:
    ok = (pred_labels == labels).to(torch.float32)
    if mask is None:
        return torch.mean(ok)
    return torch.sum(ok * mask) / torch.clamp_min(torch.sum(mask), 1.0)


def rmse(pred: torch.Tensor, y: torch.Tensor,
         mask: torch.Tensor | None = None) -> torch.Tensor:
    se = torch.square(pred - y)
    if mask is None:
        return torch.sqrt(torch.mean(se))
    return torch.sqrt(torch.sum(se * mask)
                      / torch.clamp_min(torch.sum(mask), 1.0))
