"""Sufficient statistics and the posterior solve: port of the one-device
part of ``repro/core/stats.py``.

Every worker of the paper's map-reduce (Sec 4.1) computes
Sigma^p = sum_d (1/gamma_d) x_d x_d^T and mu^p = sum_d (rho_d/gamma_d +
beta_d) x_d; the global statistics are sums over workers. On one device
the reductions are identities. The M-step is the posterior solve (EM) or
the Gaussian draw ``draw_weight`` (MC). The multi-GPU reduction is ROADMAP queue 1
item 10.
"""
from __future__ import annotations

import torch

from . import prng


def preduce(x: torch.Tensor, axes=None, live=None) -> torch.Tensor:
    """Sum over data-parallel workers; the identity on one device."""
    if axes or live is not None:
        raise NotImplementedError(
            "reductions over mesh axes are not ported yet: ROADMAP queue 1 "
            "item 10 (multi-GPU)")
    return x


def reduce_stats(S: torch.Tensor, b: torch.Tensor, axes=None):
    """All-reduce (Sigma^p, mu^p); the identity on one device."""
    return preduce(S, axes), preduce(b, axes)


def masked_mean(x: torch.Tensor, mask: torch.Tensor, axes=None
                ) -> torch.Tensor:
    """Mean of x over valid rows (a diagnostic), reduced locally."""
    num = preduce(torch.sum(x * mask), axes)
    den = preduce(torch.sum(mask), axes)
    return num / torch.clamp_min(den, 1.0)


def posterior_params(S: torch.Tensor, b: torch.Tensor, lam: float,
                     jitter: float = 0.0):
    """(L, mu) of the Gaussian conditional p(w | gamma, D) (Eq. 4/6):
    P = lam*I + S, L its lower Cholesky factor, mu = P^{-1} b.

    ``cholesky_ex`` leaves the error flag on the device; plain
    ``cholesky`` would check it and force a host sync every iteration.
    """
    K = S.shape[0]
    eye = torch.eye(K, dtype=S.dtype, device=S.device)
    P = S + lam * eye
    P = 0.5 * (P + P.T)  # exact symmetry for the factorization
    # Relative jitter: fp32 Gram statistics carry O(eps * trace/K)
    # negative eigenvalue noise; scale the ridge to the problem.
    scale = torch.trace(P) / K
    P = P + (jitter * scale) * eye
    L = torch.linalg.cholesky_ex(P).L
    mu = torch.cholesky_solve(b[:, None], L)[:, 0]
    return L, mu


def draw_weight(key: torch.Tensor, L: torch.Tensor, mu: torch.Tensor
                ) -> torch.Tensor:
    """MC draw w ~ N(mu, P^{-1}) via w = mu + L^{-T} z (paper Eq. 4), with
    z = ``prng.normal(key, (K,))`` as the reference draws it."""
    z = prng.normal(key, tuple(mu.shape)).to(mu.dtype)
    return mu + torch.linalg.solve_triangular(L.T, z[:, None],
                                              upper=True)[:, 0]
