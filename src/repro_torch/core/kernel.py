"""KRN-{EM,MC}-CLS, the exact-Gram kernel SVM (paper Sec 3.1): port of
``repro/core/kernel.py``.

The dual weight omega (N,) replaces w, the Gram matrix K replaces X, and
the prior precision becomes lam*K (pseudo-prior N(0, (lam K)^{-1})):

  gamma_d  <- |1 - y_d K_d omega|                       (Eq. 19)
  Sigma^p  =  sum_d (1/gamma_d) K_d^T K_d               (N x N)
  mu^p     =  sum_d y_d (1 + 1/gamma_d) K_d^T
  P        =  lam*K + sum_p Sigma^p,  mu = P^{-1} mu^p  (Eq. 18)

A mesh shards the rows of K (row d belongs to datum d, the paper's data
partitioning); omega is replicated. The step is the LIN statistic with
X := the Gram rows: ``ops.fused_stats`` (past FUSED_STATS_MAX_K its
``fused_estep`` + ``syrk_tri`` route, as in the reference).

Padding: the Gram matrix is padded as blockdiag(K, I) with masked rows.
Padded components see the prior precision lam*I and no statistics, so
their posterior is centred at 0 and they never touch real components.

``gram_matrix``: ``rbf`` goes through ``ops.rbf_gram`` (the hand-written
kernel on a CUDA tensor), ``linear`` is a plain product, as in the
reference.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops
from . import augment, objective, stats
from .linear import SVMData


def gram_matrix(X1: torch.Tensor, X2: torch.Tensor, *, kind: str = "rbf",
                sigma: float = 1.0, backend: str | None = None
                ) -> torch.Tensor:
    """Gram block (N1, N2) float32 between two sets of rows."""
    if kind == "rbf":
        return ops.rbf_gram(X1, X2, sigma=sigma, backend=backend)
    if kind == "linear":
        return X1.to(torch.float32) @ X2.to(torch.float32).T
    raise ValueError(f"unknown kernel kind {kind!r}")


def pad_gram(K: torch.Tensor, n_pad: int) -> torch.Tensor:
    """blockdiag(K, I_pad): keeps the padded prior well conditioned."""
    if n_pad == 0:
        return K
    N = K.shape[0]
    out = K.new_zeros((N + n_pad, N + n_pad))
    out[:N, :N] = K
    idx = torch.arange(N, N + n_pad, device=K.device)
    out[idx, idx] = 1.0
    return out


def krn_step(data: SVMData, K_prior: torch.Tensor, omega: torch.Tensor,
             key: torch.Tensor | None = None, *, mode: str = "EM",
             lam: float = 1.0, eps: float = 1e-6, jitter: float = 1e-6,
             backend: str | None = None, axes=None, triangle: bool = True,
             reduce_dtype: str | None = None, live=None):
    """One KRN-*-CLS iteration. ``data.X`` holds this shard's rows of the
    padded Gram (N_loc, N); ``K_prior`` is the whole padded Gram
    (replicated: the lam*K prior). Returns (omega_new, aux dict of 0-d
    device tensors: objective, gamma_mean).

    A padded row's Gram row is e_d, and with y = 0 it adds nothing to b;
    but Sigma would get (1/gamma_pad) e_d e_d^T with gamma_pad at the
    clamp. The mask goes to the statistic as Sigma's weight mask and
    silences it. MC pre-draws the (nu, u) noise per global row
    (``augment.draw_ig_noise`` from ``fold_in(key, row)``), so the chain
    does not depend on the mesh layout, and the inverse-Gaussian transform
    runs in the statistic's epilogue."""
    K_rows, y, mask = data
    if mode == "EM":
        epilogue, noise = "em_hinge", None
    else:
        row0 = stats.shard_row_offset(K_rows.shape[0], axes)
        epilogue = "mc_hinge"
        noise = augment.draw_ig_noise(key, K_rows.shape[0], row0)
    margin, gamma, b, S = ops.fused_stats(K_rows, y, y, omega, mask, noise,
                                          epilogue=epilogue, eps=eps,
                                          backend=backend)
    S, b = stats.reduce_stats(S, b, axes, triangle=triangle,
                              reduce_dtype=reduce_dtype, live=live)
    L, mu = stats.posterior_params(S, b, lam, prior_precision=K_prior,
                                   jitter=jitter)
    omega_new = mu if mode == "EM" else stats.draw_weight(key, L, mu)
    K_omega = K_prior @ omega_new
    obj = objective.kernel_reg(omega_new, K_omega, lam) + stats.preduce(
        objective.hinge_obj_terms(margin, y, mask), axes, live)
    return omega_new, {"objective": obj,
                       "gamma_mean": stats.masked_mean(gamma, mask, axes,
                                                       live)}


def decision_function(omega: torch.Tensor, X_train: torch.Tensor,
                      X_test: torch.Tensor, *, kind: str = "rbf",
                      sigma: float = 1.0,
                      backend: str | None = None) -> torch.Tensor:
    """f(x) = sum_d omega_d k(x_d, x) over the N training rows (omega
    without its padding)."""
    K_cross = gram_matrix(X_test, X_train, kind=kind, sigma=sigma,
                          backend=backend)
    return K_cross @ omega.to(torch.float32)
