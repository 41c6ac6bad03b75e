"""LIN-{EM,MC}-MLT: the Crammer-Singer multiclass SVM (paper Sec 3.3):
port of ``repro/core/multiclass.py``.

The outer loop cycles over the classes y = 1..M. Given the other classes'
weights w_{-y}, the class-y conditional is a binary-style augmented
problem with

  zeta_d(y) = max_{y' != y} (w_{y'}^T x_d + Delta_d(y'))
  rho_d^y   = zeta_d(y) - Delta_d(y)
  beta_d^y  = +1 if y == y_d else -1                        (Eq. 34-35)

then gamma_{yd} = |rho_d^y - w_y^T x_d| (Eq. 36) and the Gaussian step of
Eq. 38-39: exactly ``linear.accumulate_stats`` with per-class (rho,
beta), one ``ops.fused_stats`` pass over X a class. Delta is the 0/1
cost. A sweep is M statistic passes, each followed by its reduction and
its posterior solve or draw; class y's rho depends on the already updated
w_{<y}, so the sweep is sequential. The loop keeps the score matrix
F = X W^T and refreshes column y after updating w_y (one matrix-vector
product, as the reference's XLA computes it).

Nothing in a sweep waits for the device but the collectives: the class
loop is a Python loop over device tensors. The stream driver's bodies
(``mlt_class_chunk_stats``, ``mlt_chunk_obj``) recompute a chunk's F from
the current W on every class pass instead, which is the same F: its
columns are X w_c at each class's current value.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops
from . import objective, prng, stats
from .linear import PhiSpec, SVMData, _k_block, _reduce, accumulate_stats

_NEG = -1e30


def _maybe_featurize(X: torch.Tensor, mask: torch.Tensor, phi,
                     phi_spec: PhiSpec | None, backend: str | None
                     ) -> torch.Tensor:
    """The block the class passes run on: X itself, or in Nystrom
    phi-space its features (``ops.nystrom_phi``, once a step: one
    featurize serves the score matrix and all M statistic passes). Padded
    rows get zero phi rows, so they stay no-ops for Sigma and b although
    their Crammer-Singer rho is not 0."""
    if phi_spec is None:
        return X
    landmarks, proj = phi
    return ops.nystrom_phi(X, landmarks, proj, mask, sigma=phi_spec.sigma,
                           kind=phi_spec.kind, add_bias=phi_spec.add_bias,
                           backend=backend)


def _rho_beta(F: torch.Tensor, labels: torch.Tensor, y: int, M: int):
    """Class y's hinge parameters (rho, beta), each (N,) float32, from the
    score matrix F (N, M) and the integer labels."""
    class_ids = torch.arange(M, device=F.device)
    onehot_lbl = (labels[:, None] == class_ids[None, :]).to(torch.float32)
    delta = 1.0 - onehot_lbl                         # Delta_d(y'), 0/1 cost
    A = F + delta
    A_excl = torch.where(class_ids[None, :] == y,
                         torch.full_like(A, _NEG), A)
    zeta = torch.amax(A_excl, dim=1)                 # zeta_d(y)
    delta_y = (labels != y).to(torch.float32)        # Delta_d(y)
    rho = zeta - delta_y
    beta = torch.where(labels == y, 1.0, -1.0).to(torch.float32)
    return rho, beta


def mlt_class_chunk_stats(chunk: SVMData, W: torch.Tensor,
                          key: torch.Tensor | None, row0: int, y: int, *,
                          num_classes: int, mode: str, eps: float,
                          backend: str | None, phi=None,
                          phi_spec: PhiSpec | None = None,
                          rng: str = "host", chain0: int = 0) -> dict:
    """The stream driver's class-y E-step body: one chunk's (Sigma, b).
    The chunk's score matrix is recomputed from the current W (the classes
    before y already updated in this sweep), and class y's key is
    ``fold_in(key, y)`` with the rows keyed from ``row0``, as in
    ``mlt_step``, so an MC chain is that of the in-memory drivers. In
    phi-space the chunk is featurized first (``nystrom_phi``)."""
    X, labels, mask = chunk
    X = _maybe_featurize(X, mask, phi, phi_spec, backend)
    F = X.to(torch.float32) @ W.to(torch.float32).T
    rho, beta = _rho_beta(F, labels, y, num_classes)
    _, _, S, b = accumulate_stats(
        X, rho, beta, W[y], mode=mode,
        key=None if key is None else prng.fold_in(key, y), eps=eps,
        backend=backend, row0=row0, rng=rng, chain0=chain0)
    return {"S": S, "b": b}


def mlt_chunk_obj(chunk: SVMData, W: torch.Tensor, phi=None,
                  phi_spec: PhiSpec | None = None,
                  backend: str | None = None) -> dict:
    """The stream driver's objective body: a chunk's Crammer-Singer loss
    terms at the end-of-sweep W and its valid-row count (both
    additive)."""
    X, labels, mask = chunk
    X = _maybe_featurize(X, mask, phi, phi_spec, backend)
    F = X.to(torch.float32) @ W.to(torch.float32).T
    return {"loss": objective.cs_obj_terms(F, labels, mask),
            "mask_sum": torch.sum(mask)}


def mlt_step(data: SVMData, W: torch.Tensor,
             key: torch.Tensor | None = None, *, num_classes: int,
             mode: str = "EM", lam: float = 1.0, eps: float = 1e-6,
             jitter: float = 1e-6, backend: str | None = None,
             rng: str = "host", chain0: int = 0, phi=None,
             phi_spec: PhiSpec | None = None, axes=None,
             triangle: bool = True, k_shard_axis=None,
             reduce_dtype: str | None = None, live=None):
    """One MLT iteration: a sweep over the M classes. W (M, K); returns
    (W_new, {"objective"}) with a 0-d device tensor.

    Class y's key is ``fold_in(key, y)``: 'host' pre-draws its row noise
    from it, the counter modes build their seed ``pack_seed(fold_in(key,
    y), row0, chain0)`` and draw the weight from ``fold_in(fold_in(key,
    y), chain0)``. MLT runs one chain (n_chains > 1 is CLS/SVR only), so
    chain0 only picks the counter plane. On a mesh the arguments are
    ``linear.cls_step``'s; under ``k_shard_axis`` the M passes share one
    Sigma column window. ``phi``/``phi_spec`` run the sweep in Nystrom
    phi-space."""
    X, labels, mask = data
    X = _maybe_featurize(X, mask, phi, phi_spec, backend)
    M = num_classes
    Xf = X.to(torch.float32)
    row0 = stats.shard_row_offset(X.shape[0], axes)
    col_window = (None if k_shard_axis is None
                  else _k_block(W.shape[1], k_shard_axis))
    W = W.to(torch.float32).clone()
    F = Xf @ W.T                                      # (N, M)
    for y in range(M):
        rho, beta = _rho_beta(F, labels, y, M)
        ky = None if key is None else prng.fold_in(key, y)
        # Padding rows: X-row (or phi row) 0, so no statistic contribution.
        _, _, S, b = accumulate_stats(
            X, rho, beta, W[y], mode=mode, key=ky, eps=eps,
            backend=backend, row0=row0, rng=rng, chain0=chain0,
            col_window=col_window)
        S, b = _reduce(S, b, axes, k_shard_axis, triangle, reduce_dtype,
                       live)
        L, mu = stats.posterior_params(S, b, lam, jitter=jitter)
        if mode == "EM":
            w_new = mu
        else:
            if rng != "host":
                ky = prng.fold_in(ky, chain0)
            w_new = stats.draw_weight(ky, L, mu)
        W[y] = w_new
        F[:, y] = Xf @ w_new
    obj = objective.l2_reg(W, lam) + stats.preduce(
        objective.cs_obj_terms(F, labels, mask), axes, live)
    return W, {"objective": obj}


def decision_function(W: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """The (N, M) class scores X W^T."""
    return X.to(torch.float32) @ W.to(torch.float32).T


def predict(W: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """argmax_y w_y^T x (paper Eq. 29)."""
    return torch.argmax(decision_function(W, X), dim=1)
