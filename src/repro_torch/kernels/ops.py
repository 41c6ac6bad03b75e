"""Backend dispatch around the ported kernels: port of
``repro/kernels/ops.py``.

Two flavours:
  * ``ref``  — the plain PyTorch versions (``ref.py``), on any device.
  * ``cuda`` — the hand-written Hopper kernels; CUDA tensors only.

``backend=None`` picks ``cuda`` for a CUDA tensor and ``ref`` for a CPU
tensor. An explicit ``backend="ref"`` on CUDA tensors is for
``chip_smoke.py`` and the tests, which hold the kernels against it.

Routes follow the reference's, so one input takes one route in both
packages: ``fused_stats`` past FUSED_STATS_MAX_K (full width), and
``nystrom_fused_stats`` past ``nystrom_fused_fits`` (featurize with
``nystrom_phi``, then ``fused_stats``). Two differences, on purpose,
where the reference's route is a TPU memory limit: its ``nystrom_phi``
and ``nystrom_score`` fall back to plain XLA past their VMEM budgets,
and its column-windowed ``fused_stats`` past a windowed VMEM budget. The
Hopper kernels stream the landmark strip and the projection through
shared memory in chunks and tile a Sigma window at any width, so on the
card they run at every landmark count and every window. Same function,
another route.
"""
from __future__ import annotations

import torch

from . import epilogues
from . import fused_estep as _fused_estep
from . import fused_stats as _fused_stats
from . import nystrom_phi as _nystrom_phi
from . import rbf_gram as _rbf_gram
from . import ref
from . import syrk as _syrk
from . import weighted_gram as _weighted_gram

VALID_BACKENDS = ("ref", "cuda")

# The route switch of the reference, kept so that the same input takes the
# same route in both packages: the TPU fused_stats holds the whole (K, K)
# Sigma in VMEM and cannot run past this K, so above it the statistic is
# fused_estep + syrk_tri. On Hopper the cap is a routing choice, not a
# memory limit: the fused kernel tiles Sigma across CTAs at any K.
FUSED_STATS_MAX_K = 1536


def _ru(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _resolve(backend: str | None, X: torch.Tensor) -> str:
    if backend is None:
        return "cuda" if X.is_cuda else "ref"
    if backend not in VALID_BACKENDS:
        raise ValueError(f"backend must be one of {VALID_BACKENDS}, "
                         f"got {backend!r}")
    if backend == "cuda" and not X.is_cuda:
        raise ValueError("backend='cuda' needs CUDA tensors; X is on "
                         f"{X.device}")
    return backend


def _check_noise(epilogue: str, noise: tuple | None, seed=None) -> None:
    """Validate the noise configuration HERE, once, so every route fails
    with the same message (the reference's wording)."""
    got = 0 if noise is None else len(noise)
    if seed is not None:
        if got:
            raise ValueError(
                f"rng='fused' derives the {epilogue!r} noise in-kernel "
                f"from the counter seed, but {got} pre-drawn noise= "
                "operand(s) (augment.draw_ig_noise) were passed as "
                "well — drop the noise= operands or set "
                "SVMConfig.rng='host' to stream pre-drawn noise")
        return
    want = epilogues.noise_arity(epilogue)
    if got != want:
        raise ValueError(
            f"epilogue {epilogue!r} needs {want} pre-drawn noise "
            f"operands (augment.draw_ig_noise), got {got} — or pass "
            "seed= (SVMConfig.rng='fused') to derive them in-kernel")


def _f32(v: torch.Tensor) -> torch.Tensor:
    return v.to(torch.float32).contiguous()


def _mask32(mask):
    return None if mask is None else _f32(mask)


def _noise32(noise):
    return None if noise is None else tuple(_f32(z) for z in noise)


def weighted_gram(X: torch.Tensor, w: torch.Tensor, *,
                  backend: str | None = None) -> torch.Tensor:
    """S = X^T diag(w) X, (K, K) float32, over the dense tile grid (the
    paper's Table 9 statistic; ``syrk_tri`` computes only the lower
    triangle)."""
    if _resolve(backend, X) == "ref":
        return ref.weighted_gram(X, w)
    return _weighted_gram.weighted_gram(X, _f32(w))


def syrk_tri(X: torch.Tensor, w: torch.Tensor, *,
             backend: str | None = None) -> torch.Tensor:
    """S = X^T diag(w) X computing only lower-triangle tiles; the result
    is the full symmetric (K, K) float32 matrix."""
    if _resolve(backend, X) == "ref":
        return ref.syrk_tri(X, w)
    return _syrk.syrk_tri(X, _f32(w))


def fused_estep(X: torch.Tensor, rho: torch.Tensor, beta: torch.Tensor,
                wvec: torch.Tensor, *, eps: float = 1e-6,
                backend: str | None = None):
    """(margin, gamma, b): the EM gamma update fused with the
    mu-numerator statistic."""
    if _resolve(backend, X) == "ref":
        return ref.fused_estep(X, rho, beta, wvec, eps)
    return _fused_estep.fused_estep(X, _f32(rho), _f32(beta), _f32(wvec),
                                    eps=eps)


def fused_stats(X: torch.Tensor, rho: torch.Tensor, beta: torch.Tensor,
                wvec: torch.Tensor, wmask: torch.Tensor | None = None,
                noise: tuple | None = None, *,
                epilogue: str = "em_hinge", eps: float = 1e-6,
                eps_ins: float = 0.0, col_window: tuple | None = None,
                seed: torch.Tensor | None = None,
                backend: str | None = None):
    """(margin, *aug, b, S): the whole iteration statistic in one X
    pass, under any epilogue: em_hinge / mc_hinge give aug = (gamma,),
    em_svr / mc_svr (rho the target y, tube ``eps_ins``) give
    (gamma, omega). The MC epilogues take pre-drawn ``noise`` ((nu, u), or
    SVR's (nu_g, u_g, nu_o, u_o)) or derive it from ``seed`` (the (4,)
    words of ``rng.pack_seed``); a 2-D (K, C) ``wvec`` with ``seed`` runs
    C chains: margin and aug (N, C), b (K, C), S (C, K, K).

    Routes, as the reference's kernel routes: for K > FUSED_STATS_MAX_K
    a single chain takes fused_estep + syrk_tri (em_hinge) or the
    generalised split fallback (a plain E-step, then syrk_tri), in both
    flavours. Multichain differs: the TPU kernel cannot hold C Sigma
    blocks past the cap and the reference runs plain XLA there, while
    the Hopper kernel tiles Sigma at any K * C, so the cuda flavour runs
    the multichain kernel at every width. Callers get the same outputs
    either way.

    ``col_window = (start, blk)`` narrows S to its column block
    S[:, start:start + blk], (K, blk): the statistic of one k-shard of
    the 2-D (data x k) fit. Margin, aug and b stay full width. On the card
    every window runs the window kernel, at any K (the reference's
    windowed VMEM budget is a TPU limit). A window does not compose with
    multichain."""
    _check_noise(epilogue, noise, seed)
    epilogues.check_epilogue(epilogue)
    multi = wvec.dim() == 2
    if multi and seed is None:
        raise ValueError("multichain fused_stats (2-D wvec) requires the "
                         "counter seed (rng='fused')")
    flavour = _resolve(backend, X)
    if col_window is not None:
        if multi:
            raise ValueError("multichain fused_stats does not compose with "
                             "a column window")
        window = ref.check_window(col_window, X.shape[1])
        if flavour == "ref":
            return ref.fused_stats(X, rho, beta, wvec, wmask, eps, epilogue,
                                   noise=noise, seed=seed, eps_ins=eps_ins,
                                   col_window=window)
        return _fused_stats.fused_stats(
            X, _f32(rho), _f32(beta), _f32(wvec), _mask32(wmask),
            noise=_noise32(noise), seed=seed, epilogue=epilogue, eps=eps,
            eps_ins=eps_ins, col_window=window)
    if multi or X.shape[1] <= FUSED_STATS_MAX_K:
        if flavour == "ref":
            return ref.fused_stats(X, rho, beta, wvec, wmask, eps, epilogue,
                                   noise=noise, seed=seed, eps_ins=eps_ins)
        return _fused_stats.fused_stats(
            X, _f32(rho), _f32(beta), _f32(wvec), _mask32(wmask),
            noise=_noise32(noise), seed=seed, epilogue=epilogue, eps=eps,
            eps_ins=eps_ins)
    if epilogue == "em_hinge":
        margin, gamma, b = fused_estep(X, rho, beta, wvec, eps=eps,
                                       backend=flavour)
        w = (1.0 / gamma) if wmask is None else wmask.to(gamma.dtype) / gamma
        return margin, gamma, b, syrk_tri(X, w, backend=flavour)
    # Generalised split fallback: the O(NK) E-step (margin, aug, coef,
    # b) in plain PyTorch, the O(NK^2) Sigma through syrk_tri.
    if seed is not None:
        noise = ref.seed_noise(seed, X.shape[0], 1, epilogue)
    Xf = X.to(torch.float32)
    margin = Xf @ wvec.to(torch.float32)
    aug, weight, coef = epilogues.apply_epilogue(
        epilogue, margin, rho.to(torch.float32), beta.to(torch.float32),
        noise, eps, eps_ins)
    w = weight if wmask is None else wmask.to(torch.float32) * weight
    return (margin, *aug, Xf.T @ coef, syrk_tri(X, w, backend=flavour))


def rbf_gram(X1: torch.Tensor, X2: torch.Tensor, *, sigma: float = 1.0,
             backend: str | None = None) -> torch.Tensor:
    """RBF Gram matrix (N1, N2) float32."""
    if _resolve(backend, X1) == "ref":
        return ref.rbf_gram(X1, X2, float(sigma))
    return _rbf_gram.rbf_gram(X1.contiguous(), X2.contiguous(), sigma=sigma)


# The reference's route rule for the Nystrom statistic, copied with its
# byte formula so that one input takes one route in both packages. On the
# TPU the fused kernel holds the landmark strip, the projection, the phi
# tile and the (M, M) Sigma accumulator in VMEM at once and must not run
# past this landmark count or the budget; past them the statistic is
# featurize (nystrom_phi) then accumulate (fused_stats, itself routed at
# FUSED_STATS_MAX_K). On Hopper the rule is a routing choice: the kernel
# streams all of them at any m.
NYSTROM_FUSED_MAX_M = 1024
_NYSTROM_VMEM_BUDGET = 14 * 2 ** 20


def _nystrom_vmem_words(n_landmarks: int, n_features: int, add_bias: bool,
                        block_n: int, epilogue: str = "em_hinge",
                        col_blk: int | None = None,
                        rng: bool = False) -> int:
    """fp32 words resident per grid step of the reference's featurize-
    and-accumulate kernel: the X tile, landmark strip, projection, cross
    tile and phi tile, the Sigma/b accumulators and the per-row vectors
    (the noise operands only without the in-kernel RNG). ``col_blk``
    narrows Sigma to its aligned column window."""
    Lp = _ru(n_landmarks, 128)
    Dp = _ru(n_features, 128)
    Wp = _ru(n_landmarks + int(add_bias), 128)
    words = (block_n * Dp        # X tile
             + Lp * Dp           # landmark strip
             + Lp * Wp           # projection
             + block_n * Lp      # cross-Gram tile
             + block_n * Wp)     # phi tile
    per_row = (4                                   # mask/rho/beta/margin
               + (0 if rng else epilogues.noise_arity(epilogue))
               + epilogues.aug_arity(epilogue))
    Cw = Wp if col_blk is None else min(Wp, _ru(col_blk, 128) + 128)
    return words + (Wp * Cw      # Sigma accumulator (windowed: narrowed)
                    + Wp + per_row * block_n)  # w/b + per-row vectors


def nystrom_fused_fits(n_landmarks: int, n_features: int,
                       add_bias: bool = True, block_n: int = 256,
                       epilogue: str = "em_hinge",
                       col_blk: int | None = None,
                       rng: bool = False) -> bool:
    """Whether the reference's one-pass featurize-and-accumulate kernel
    runs at these sizes (its VMEM budget). ``rng=True`` (the counter
    seed) drops the noise vectors from the count, so the seed and noise
    variants can take different routes at the edge."""
    if n_landmarks > NYSTROM_FUSED_MAX_M:
        return False
    return 4 * _nystrom_vmem_words(n_landmarks, n_features, add_bias,
                                   block_n, epilogue, col_blk,
                                   rng) <= _NYSTROM_VMEM_BUDGET


def nystrom_phi(X: torch.Tensor, landmarks: torch.Tensor,
                proj: torch.Tensor, mask: torch.Tensor | None = None, *,
                sigma: float = 1.0, kind: str = "rbf",
                add_bias: bool = False,
                backend: str | None = None) -> torch.Tensor:
    """Device-side Nystrom featurizer: phi = k(X, landmarks) @ proj with
    rows multiplied by ``mask`` and an optional mask-valued bias column
    last, (N, M) float32, M = proj cols + add_bias."""
    if _resolve(backend, X) == "ref":
        return ref.nystrom_phi(X, landmarks, proj, mask, float(sigma), kind,
                               add_bias)
    return _nystrom_phi.nystrom_phi(
        X.contiguous(), _f32(landmarks), _f32(proj), _mask32(mask),
        sigma=sigma, kind=kind, add_bias=add_bias)


def nystrom_score(X: torch.Tensor, landmarks: torch.Tensor,
                  proj: torch.Tensor, W: torch.Tensor,
                  mask: torch.Tensor | None = None, *, sigma: float = 1.0,
                  kind: str = "rbf", add_bias: bool = False,
                  backend: str | None = None) -> torch.Tensor:
    """(N, C) scores = nystrom_phi(X, ...) @ W in one pass: phi is never
    written to device memory. Masked rows score 0."""
    if _resolve(backend, X) == "ref":
        return ref.nystrom_score(X, landmarks, proj, W, mask, float(sigma),
                                 kind, add_bias)
    return _nystrom_phi.nystrom_score(
        X.contiguous(), _f32(landmarks), _f32(proj), _f32(W),
        _mask32(mask), sigma=sigma, kind=kind, add_bias=add_bias)


def nystrom_fused_stats(X: torch.Tensor, landmarks: torch.Tensor,
                        proj: torch.Tensor, rho: torch.Tensor,
                        beta: torch.Tensor, wvec: torch.Tensor,
                        mask: torch.Tensor | None = None,
                        noise: tuple | None = None, *,
                        sigma: float = 1.0, kind: str = "rbf",
                        add_bias: bool = False, epilogue: str = "em_hinge",
                        eps: float = 1e-6, eps_ins: float = 0.0,
                        col_window: tuple | None = None,
                        seed: torch.Tensor | None = None,
                        backend: str | None = None):
    """(margin, *aug, b, S): the phi-space iteration statistic,
    ``fused_stats`` on nystrom_phi(X) with S weighted by mask times the
    epilogue's weight; aug is (gamma,) or, under SVR, (gamma, omega).

    Within ``nystrom_fused_fits`` it is one call of the featurize-and-
    accumulate kernel, which allocates no (N, M) phi; past it (m > 1024,
    or wide D) it is nystrom_phi, then fused_stats on phi, as in the
    reference. Callers get the same outputs either way.

    ``col_window = (start, blk)`` narrows S to a block of phi columns,
    (M, blk): the phi-space statistic of one k-shard. The route rule
    counts the window (``nystrom_fused_fits(..., col_blk=blk)``)."""
    _check_noise(epilogue, noise, seed)
    epilogues.check_epilogue(epilogue)
    flavour = _resolve(backend, X)
    window = (None if col_window is None else ref.check_window(
        col_window, proj.shape[1] + int(add_bias)))
    if not nystrom_fused_fits(landmarks.shape[0], X.shape[1], add_bias,
                              256, epilogue,
                              None if window is None else window[1],
                              seed is not None):
        phi = nystrom_phi(X, landmarks, proj, mask, sigma=sigma, kind=kind,
                          add_bias=add_bias, backend=flavour)
        return fused_stats(phi, rho, beta, wvec, mask, noise,
                           epilogue=epilogue, eps=eps, eps_ins=eps_ins,
                           col_window=window, seed=seed, backend=flavour)
    if flavour == "ref":
        return ref.nystrom_fused_stats(
            X, landmarks, proj, rho, beta, wvec, mask, float(sigma), kind,
            add_bias, eps, epilogue, noise=noise, col_window=window,
            seed=seed, eps_ins=eps_ins)
    return _nystrom_phi.nystrom_fused_stats(
        X.contiguous(), _f32(landmarks), _f32(proj), _f32(rho), _f32(beta),
        _f32(wvec), _mask32(mask), noise=_noise32(noise), seed=seed,
        sigma=sigma, kind=kind, add_bias=add_bias, epilogue=epilogue,
        eps=eps, eps_ins=eps_ins, col_window=window)
