"""LIN-{EM,MC}-SVR: support vector regression via the double scale mixture
(paper Sec 3.2, Lemma 3). Port of ``repro/core/svr.py``.

Two augmentation variables per datum for the eps-insensitive loss
max(0, |y - w^T x| - eps_ins):

  gamma_d <- |y_d - w^T x_d - eps_ins|     (Eq. 25)
  omega_d <- |y_d - w^T x_d + eps_ins|     (Eq. 26)

  Sigma = X^T diag(1/gamma + 1/omega) X                 (Eq. 27)
  mu    = X^T ((y - eps)/gamma + (y + eps)/omega)       (Eq. 28)

Both mixtures run as the ``em_svr`` / ``mc_svr`` epilogue of one fused
statistic, in X-space (``ops.fused_stats``) or, with ``phi_spec``, in
Nystrom phi-space (``ops.nystrom_fused_stats``), on one device or on a
mesh (as ``linear.cls_step``), or chunk by chunk in the stream driver
(``svr_chunk_stats``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops
from . import augment, objective, stats
from .linear import (PhiSpec, SVMData, _k_block, _reduce, chain_keys,
                     multichain_draw)


def svr_local_stats(X: torch.Tensor, y: torch.Tensor, w: torch.Tensor, *,
                    mode: str, key: torch.Tensor | None, eps: float,
                    eps_ins: float, backend: str | None, row0: int = 0,
                    phi=None, phi_spec: PhiSpec | None = None,
                    mask: torch.Tensor | None = None, rng: str = "host",
                    chain0: int = 0, col_window: tuple | None = None):
    """(pred, gamma, omega, Sigma, mu) over one row block, in one X pass.

    MC noise comes from ``rng``: 'host' splits the key into (k_lo, k_hi)
    and pre-draws gamma's pair from k_lo and omega's from k_hi
    (``augment.draw_svr_noise``); 'fused' passes the counter seed and
    the kernel derives both mixtures in-body from one key (gamma's on
    counter words chain*4 + {0, 1}, omega's on chain*4 + {2, 3});
    'fused_predraw' materializes that stream. Padded rows (X-row 0,
    y = 0) have a nonzero weight and coef under SVR: in X-space the zero
    X row makes them no-ops, in phi-space ``mask``. ``col_window`` narrows
    Sigma to one k-shard's column block."""
    epilogue = "em_svr" if mode == "EM" else "mc_svr"
    noise = seed = None
    if mode == "MC":
        if rng == "host":
            noise = augment.draw_svr_noise(key, X.shape[0], row0)
        elif rng == "fused_predraw":
            noise = augment.draw_fused_noise(key, X.shape[0], row0, chain0,
                                             4)
        else:
            assert rng == "fused", rng
            seed = augment.pack_seed(key, row0, chain0)
    beta0 = torch.zeros(X.shape[0], dtype=torch.float32, device=X.device)
    if phi_spec is not None:
        landmarks, proj = phi
        if mask is None:
            mask = torch.ones(X.shape[0], dtype=torch.float32,
                              device=X.device)
        pred, gamma, omega, b, S = ops.nystrom_fused_stats(
            X, landmarks, proj, y, beta0, w, mask, noise,
            sigma=phi_spec.sigma, kind=phi_spec.kind,
            add_bias=phi_spec.add_bias, epilogue=epilogue, eps=eps,
            eps_ins=eps_ins, col_window=col_window, seed=seed,
            backend=backend)
    else:
        pred, gamma, omega, b, S = ops.fused_stats(
            X, y, beta0, w, None, noise, epilogue=epilogue, eps=eps,
            eps_ins=eps_ins, col_window=col_window, seed=seed,
            backend=backend)
    return pred, gamma, omega, S, b


def svr_chunk_stats(chunk: SVMData, w: torch.Tensor,
                    key: torch.Tensor | None, row0: int, *, mode: str,
                    eps: float, eps_ins: float, backend: str | None,
                    phi=None, phi_spec: PhiSpec | None = None,
                    rng: str = "host", n_chains: int = 1,
                    chain0: int = 0) -> dict:
    """The stream driver's E-step body for SVR: one chunk's additive
    contributions (summed over the chunks by the driver). Multichain
    chunks carry S (C, K, K), b (K, C) and chain-mean diagnostics, as
    ``linear.cls_chunk_stats``."""
    X, y, mask = chunk
    multi = n_chains > 1
    pred, gamma, omega, S, b = svr_local_stats(
        X, y, w.T if multi else w, mode=mode, key=key, eps=eps,
        eps_ins=eps_ins, backend=backend, row0=row0, phi=phi,
        phi_spec=phi_spec, mask=mask, rng=rng, chain0=chain0)
    if multi:
        maskc = mask[:, None].expand_as(pred)
        return {"S": S, "b": b,
                "loss": objective.svr_obj_terms(pred, y[:, None], eps_ins,
                                                maskc) / n_chains,
                "gamma_sum": torch.sum(gamma * maskc) / n_chains,
                "omega_sum": torch.sum(omega * maskc) / n_chains,
                "mask_sum": torch.sum(mask)}
    return {"S": S, "b": b,
            "loss": objective.svr_obj_terms(pred, y, eps_ins, mask),
            "gamma_sum": torch.sum(gamma * mask),
            "omega_sum": torch.sum(omega * mask),
            "mask_sum": torch.sum(mask)}


def svr_step(data: SVMData, w: torch.Tensor,
             key: torch.Tensor | None = None, *, mode: str = "EM",
             lam: float = 1.0, eps: float = 1e-6, eps_ins: float = 1e-3,
             jitter: float = 1e-6, backend: str | None = None,
             rng: str = "host", n_chains: int = 1, chain0: int = 0,
             phi=None, phi_spec: PhiSpec | None = None, axes=None,
             triangle: bool = True, k_shard_axis=None,
             reduce_dtype: str | None = None, live=None):
    """One LIN-*-SVR iteration. Returns (w_new, aux dict of 0-d device
    tensors: objective, gamma_mean, omega_mean); nothing in it waits for
    the device but the collectives. ``rng``/``n_chains``/``chain0``,
    ``phi``/``phi_spec`` and the mesh arguments (``axes``,
    ``k_shard_axis``, ``triangle``, ``reduce_dtype``, ``live``) as in
    ``linear.cls_step``: the state is chain-major (C, K) when
    n_chains > 1."""
    X, y, mask = data
    multi = n_chains > 1
    row0 = stats.shard_row_offset(X.shape[0], axes)
    col_window = (None if k_shard_axis is None
                  else _k_block(w.shape[-1], k_shard_axis))
    pred, gamma, omega, S, b = svr_local_stats(
        X, y, w.T if multi else w, mode=mode, key=key, eps=eps,
        eps_ins=eps_ins, backend=backend, row0=row0, phi=phi,
        phi_spec=phi_spec, mask=mask, rng=rng, chain0=chain0,
        col_window=col_window)
    S, b = _reduce(S, b, axes, k_shard_axis, triangle, reduce_dtype, live)
    if multi:
        w_new = multichain_draw(key, S, b, lam, jitter, chain0)
        maskc = mask[:, None].expand_as(pred)
        obj = objective.l2_reg(w_new, lam) / n_chains + stats.preduce(
            objective.svr_obj_terms(pred, y[:, None], eps_ins, maskc), axes,
            live) / n_chains
        return w_new, {
            "objective": obj,
            "gamma_mean": stats.masked_mean(gamma, maskc, axes, live),
            "omega_mean": stats.masked_mean(omega, maskc, axes, live)}
    L, mu = stats.posterior_params(S, b, lam, jitter=jitter)
    if mode == "EM":
        w_new = mu
    elif rng == "host":
        w_new = stats.draw_weight(key, L, mu)
    else:
        w_new = stats.draw_weight(chain_keys(key, chain0, 1)[0], L, mu)
    obj = objective.l2_reg(w_new, lam) + stats.preduce(
        objective.svr_obj_terms(pred, y, eps_ins, mask), axes, live)
    return w_new, {"objective": obj,
                   "gamma_mean": stats.masked_mean(gamma, mask, axes, live),
                   "omega_mean": stats.masked_mean(omega, mask, axes, live)}
