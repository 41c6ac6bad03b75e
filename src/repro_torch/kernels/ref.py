"""Plain PyTorch versions of the ported kernels: port of
``repro/kernels/ref.py`` (the hinge and SVR epilogues, pre-drawn noise,
the counter seed and multichain; the column window of the statistic; the
weighted Gram; the RBF Gram and the Nystrom featurizer, scorer and
statistic).

They are the CPU path of ``ops`` and the oracles the CUDA kernels are held
against. Inputs are computed in float32, as in the reference; float64
inputs stay float64, which is how ``chip_smoke.py`` evaluates the plain
version exactly. Padded rows (X-row 0) contribute nothing to b and Sigma;
under the SVR epilogues their weight and coef are not zero, so it is the
zero X row (X-space) or the mask (phi-space) that makes them no-ops.
"""
from __future__ import annotations

import torch

from . import epilogues
from ._build import ROWS_PER_SPLIT


def seed_noise(seed: torch.Tensor, n: int, n_chains: int, epilogue: str):
    """The counter stream the fused kernel derives in-body for ``n`` rows
    from ``seed`` = [k0, k1, row0, chain0]: the epilogue's noise tuple of
    (n,) tensors for one chain, (n, n_chains) for a multichain call."""
    noise = epilogues.fused_noise(seed, 0, (n, n_chains), epilogue)
    return noise if n_chains > 1 else tuple(z[:, 0] for z in noise)


def _acc(t: torch.Tensor) -> torch.Tensor:
    return t if t.dtype == torch.float64 else t.float()


def check_window(col_window, K: int) -> tuple[int, int]:
    """(start, blk) of a Sigma column window over K columns, as Python
    ints; raises unless 0 <= start and 1 <= blk and start + blk <= K
    (the reference's dynamic slice would clamp instead)."""
    start, blk = (int(v) for v in col_window)
    if start < 0 or blk < 1 or start + blk > K:
        raise ValueError(f"col_window ({start}, {blk}) is not a column "
                         f"block of a width-{K} Sigma")
    return start, blk


def weighted_gram(X: torch.Tensor, w: torch.Tensor,
                  col_window: tuple | None = None) -> torch.Tensor:
    """S = X^T diag(w) X, (K, K), summed over splits of ROWS_PER_SPLIT
    rows in order (the kernels sum splits of at most that many). One
    float32 product over a million rows has several times the error: on
    the 1e6-row Nystrom statistic (``chip_nystrom_numerics.py``) it was
    6.6 from float64 in the 2-norm, pushed an eigenvalue to -1.4 against
    a ridge of 0.3 and broke the Cholesky, where the split sum stays
    within 2.0. ``col_window = (start, blk)`` gives the column block
    S[:, start:start + blk], (K, blk)."""
    Xf, wf = _acc(X), _acc(w)
    win = (None if col_window is None
           else check_window(col_window, X.shape[1]))
    S = None
    for r0 in range(0, max(X.shape[0], 1), ROWS_PER_SPLIT):
        Xb = Xf[r0:r0 + ROWS_PER_SPLIT]
        Xc = Xb if win is None else Xb[:, win[0]:win[0] + win[1]]
        part = (Xb * wf[r0:r0 + ROWS_PER_SPLIT, None]).T @ Xc
        S = part if S is None else S + part
    return S


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
                seed: torch.Tensor | None = None, eps_ins: float = 0.0,
                col_window: tuple | None = None):
    """(margin, *aug, b, S): the whole iteration statistic with
    S = X^T diag(wmask * weight) X (wmask defaults to ones); aug is
    (gamma,) for the hinge epilogues and (gamma, omega) for SVR, whose
    tube is ``eps_ins``. MC epilogues take pre-drawn ``noise`` or derive
    it from ``seed`` (``seed_noise``). A 2-D (K, C) ``wvec`` (seed
    required) runs C chains: margin and aug (N, C), b (K, C),
    S (C, K, K). ``col_window = (start, blk)`` narrows S to its column
    block S[:, start:start + blk], (K, blk), the statistic of the 2-D
    (data x k) ``k_shard_axis`` fit; margin, aug and b stay full width.
    A window does not compose with multichain (as in the reference)."""
    Xf = _acc(X)
    if wvec.dim() == 2:
        assert seed is not None, "multichain fused_stats requires seed"
        if col_window is not None:
            raise ValueError("multichain fused_stats does not compose with "
                             "a column window")
        C = wvec.shape[1]
        margin = Xf @ _acc(wvec)
        noise = seed_noise(seed, X.shape[0], C, epilogue)
        aug, weight, coef = epilogues.apply_epilogue(
            epilogue, margin, _acc(rho)[:, None], _acc(beta)[:, None],
            noise, eps, eps_ins)
        w = weight if wmask is None else _acc(wmask)[:, None] * weight
        S = torch.stack([weighted_gram(X, w[:, c]) for c in range(C)])
        return (margin, *aug, Xf.T @ coef, S)
    if seed is not None:
        noise = seed_noise(seed, X.shape[0], 1, epilogue)
    margin = Xf @ _acc(wvec)
    aug, weight, coef = epilogues.apply_epilogue(
        epilogue, margin, _acc(rho), _acc(beta), noise, eps, eps_ins)
    w = weight if wmask is None else _acc(wmask) * weight
    return (margin, *aug, Xf.T @ coef, weighted_gram(X, w, col_window))


def rbf_gram(X1: torch.Tensor, X2: torch.Tensor, sigma: float
             ) -> torch.Tensor:
    """RBF Gram block K_ij = exp(-max(|x1_i|^2 - 2 x1_i.x2_j + |x2_j|^2, 0)
    / (2 sigma^2)), (N1, N2); float32 unless an input is float64."""
    dt = torch.promote_types(_acc(X1).dtype, _acc(X2).dtype)
    X1f, X2f = X1.to(dt), X2.to(dt)
    sq1 = torch.sum(X1f * X1f, dim=-1, keepdim=True)
    sq2 = torch.sum(X2f * X2f, dim=-1, keepdim=True)
    d2 = sq1 - 2.0 * (X1f @ X2f.T) + sq2.T
    return torch.exp(-d2.clamp_min(0.0) / (2.0 * sigma * sigma))


def nystrom_phi(X: torch.Tensor, landmarks: torch.Tensor,
                proj: torch.Tensor, mask: torch.Tensor | None,
                sigma: float, kind: str, add_bias: bool) -> torch.Tensor:
    """phi = k(X, landmarks) @ proj, (N, M) with M = proj cols + add_bias:
    the bias column (value 1) goes LAST, then every row is multiplied by
    ``mask`` (None: all ones). A zero X row is not a zero phi row under
    rbf, so padding must be masked."""
    Xf = _acc(X)
    if kind == "rbf":
        kmat = rbf_gram(Xf, landmarks, sigma)
    elif kind == "linear":
        kmat = Xf @ landmarks.to(Xf.dtype).T
    else:
        raise ValueError(f"unknown kernel kind {kind!r}")
    phi = kmat @ proj.to(kmat.dtype)
    maskv = (torch.ones((X.shape[0], 1), dtype=phi.dtype, device=X.device)
             if mask is None else mask.to(phi.dtype)[:, None])
    if add_bias:
        phi = torch.cat([phi, torch.ones_like(maskv)], dim=1)
    return phi * maskv


def nystrom_score(X: torch.Tensor, landmarks: torch.Tensor,
                  proj: torch.Tensor, W: torch.Tensor,
                  mask: torch.Tensor | None, sigma: float, kind: str,
                  add_bias: bool) -> torch.Tensor:
    """(N, C) scores = nystrom_phi(X, ...) @ W; masked rows score 0."""
    phi = nystrom_phi(X, landmarks, proj, mask, sigma, kind, add_bias)
    return phi @ W.to(phi.dtype)


def nystrom_fused_stats(X: torch.Tensor, landmarks: torch.Tensor,
                        proj: torch.Tensor, rho: torch.Tensor,
                        beta: torch.Tensor, wvec: torch.Tensor,
                        mask: torch.Tensor | None, sigma: float, kind: str,
                        add_bias: bool, eps: float,
                        epilogue: str = "em_hinge",
                        noise: tuple | None = None,
                        col_window: tuple | None = None,
                        seed: torch.Tensor | None = None,
                        eps_ins: float = 0.0):
    """``fused_stats`` on ``nystrom_phi``: (margin, *aug, b (M,),
    S (M, M)) with S weighted by mask times the epilogue's weight;
    ``col_window`` narrows S to a block of phi columns, (M, blk)."""
    phi = nystrom_phi(X, landmarks, proj, mask, sigma, kind, add_bias)
    return fused_stats(phi, rho, beta, wvec, mask, eps, epilogue,
                       noise=noise, seed=seed, eps_ins=eps_ins,
                       col_window=col_window)


def dcd_sweep(X: torch.Tensor, y: torch.Tensor, qdiag: torch.Tensor,
              order: torch.Tensor, C: float):
    """(w (K,), alpha (N,)): dual coordinate descent over the rows
    ``order`` names, in order, from w = 0 and alpha = 0, as the
    reference's ``lax.scan`` steps (``repro/baselines/dcd.py``):
    G = y_i (x_i . w) - 1, a = clip(alpha_i - G / max(q_ii, 1e-12), 0, C),
    w += (a - alpha_i) y_i x_i. ``torch.clamp`` and ``torch.maximum`` pass
    NaN as ``jnp.clip`` and ``jnp.maximum`` do."""
    Xf = _acc(X)
    yf, qf = _acc(y), _acc(qdiag)
    w = torch.zeros(X.shape[1], dtype=Xf.dtype, device=X.device)
    alpha = torch.zeros(X.shape[0], dtype=Xf.dtype, device=X.device)
    floor = torch.tensor(1e-12, dtype=Xf.dtype, device=X.device)
    for i in order.tolist():
        xi, yi, ai = Xf[i], yf[i], alpha[i].clone()
        G = yi * (xi @ w) - 1.0
        a_new = torch.clamp(ai - G / torch.maximum(qf[i], floor), 0.0, C)
        w = w + ((a_new - ai) * yi) * xi
        alpha[i] = a_new
    return w, alpha
