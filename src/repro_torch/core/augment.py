"""Polson-Scott data augmentation, the draw-generation half: port of
``repro/core/augment.py``.

  EM   (Eq. 9):  gamma_d = |rho_d - w^T x_d|
  MCMC (Eq. 5):  gamma_d^{-1} ~ InverseGaussian(|rho_d - w^T x_d|^{-1}, 1)

The MC draw is split in two: ``draw_ig_noise`` pre-draws the per-row
(nu, u) pair the mc_hinge epilogue consumes, keyed by GLOBAL row index
(one ``fold_in`` a row), so the chain does not depend on how rows are
batched; the transform (``kernels/epilogues.ig_transform``) runs inside
the fused statistic on the margin. ``gamma_mc_rowwise`` is the oracle
that composes the two. SVR's double mixture draws two such pairs
(``draw_svr_noise``). Under rng modes 'fused' / 'fused_predraw' the
noise comes from the counter cipher instead (``draw_fused_noise``,
``pack_seed``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.epilogues import (_MU_MAX,  # noqa: F401
                                           ig_gamma_from_noise,
                                           ig_transform)
from repro_torch.kernels.rng import draw_fused_noise, pack_seed  # noqa: F401
from . import prng


def draw_ig_noise(key: torch.Tensor, n: int, row0=0):
    """(nu, u), each (n,) float32: row d draws from
    ``fold_in(key, row0 + d)`` split into a normal key and a uniform key,
    the keying and draw order of ``gamma_mc_rowwise``."""
    ids = row0 + torch.arange(n, dtype=torch.int64, device=key.device)
    k = prng.split(prng.fold_in(key, ids))       # (n, 2, 2)
    return prng.normal(k[:, 0]), prng.uniform(k[:, 1])


def draw_svr_noise(key: torch.Tensor, n: int, row0=0):
    """(nu_g, u_g, nu_o, u_o) for SVR's double mixture under rng='host':
    the key splits into (k_lo, k_hi); gamma's pair is ``draw_ig_noise``
    on k_lo, omega's on k_hi, as ``repro/core/svr.py`` draws them."""
    k_lo, k_hi = prng.split(key)
    return draw_ig_noise(k_lo, n, row0) + draw_ig_noise(k_hi, n, row0)


def gamma_mc_rowwise(key: torch.Tensor, residual: torch.Tensor, eps: float,
                     row0=0) -> torch.Tensor:
    """Gibbs gamma update with one key per global row: the draw depends
    only on (iteration key, global row), not on the batching."""
    nu, u = draw_ig_noise(key, residual.shape[0], row0)
    return ig_gamma_from_noise(residual, nu, u, eps)
