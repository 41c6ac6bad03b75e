"""Per-row augmentation epilogues: what sits between the margin and the
(b, Sigma) accumulators of the fused statistic.

Port of ``repro/kernels/epilogues.py``: ``em_hinge`` and ``mc_hinge``,
and SVR's double mixture ``em_svr`` and ``mc_svr`` (paper Eq. 25-28). The
CUDA kernels carry the same arithmetic as ``__device__`` code
(``csrc/epilogues.cuh``), rounded op by op as PyTorch's eager ops round it
(no fused multiply-add), so the kernel and this plain version give the
same gamma (and omega) for the same margin and noise.

MC draws are split into draw generation and transform: the per-row
(nu, u) pairs come either pre-drawn (``core/augment.draw_ig_noise``, or
the materialized counter stream ``rng.draw_fused_noise``) or from the
counter cipher (``fused_noise``), and ``ig_transform`` maps them to the
inverse-Gaussian draw.

Epilogue contract: ``apply_epilogue`` maps the margin to
(aug, sigma_weight, coef) where aug = (gamma,) for the hinge and
(gamma, omega) for SVR, Sigma = X^T diag(wmask * sigma_weight) X and
b = X^T coef.
"""
from __future__ import annotations

import torch

from . import rng

# Clamp for the IG mean (mu = 1/|residual| explodes as the margin hits
# the hinge knee). 1/MU_MAX is far below any useful gamma clamp.
_MU_MAX = 1e8

EPILOGUES = ("em_hinge", "mc_hinge", "em_svr", "mc_svr")

# (nu, u) operand pairs consumed per row: one per IG mixture drawn.
_NOISE_ARITY = {"em_hinge": 0, "mc_hinge": 2, "em_svr": 0, "mc_svr": 4}
# augmentation variables emitted per row: (gamma,) or (gamma, omega).
_AUG_ARITY = {"em_hinge": 1, "mc_hinge": 1, "em_svr": 2, "mc_svr": 2}

def noise_arity(epilogue: str) -> int:
    """Number of pre-drawn (N,) noise operands the epilogue consumes."""
    return _NOISE_ARITY[epilogue]


def aug_arity(epilogue: str) -> int:
    """Number of per-row augmentation outputs (1 hinge, 2 SVR)."""
    return _AUG_ARITY[epilogue]


def fused_noise(seed: torch.Tensor, tile_row0: int, shape: tuple,
                epilogue: str):
    """Counter noise for a (rows, chains) block starting at operand row
    ``tile_row0``: rows advance along dim 0 from seed[2] + tile_row0,
    chains along dim 1 from seed[3]. Equal to ``rng.draw_fused_noise``
    at the same coordinates."""
    n, c = shape
    dev = seed.device
    rows = (seed[2] + tile_row0
            + torch.arange(n, dtype=torch.int64, device=dev))[:, None]
    chains = seed[3] + torch.arange(c, dtype=torch.int64, device=dev)
    return rng.counter_noise(seed[0], seed[1], rows, chains[None, :],
                             _NOISE_ARITY[epilogue])


def ig_transform(mu: torch.Tensor, nu: torch.Tensor, u: torch.Tensor,
                 lam: float = 1.0) -> torch.Tensor:
    """Michael-Schucany-Haas IG(mu, lam) transform of pre-drawn noise:
    x = mu + mu^2 y/(2 lam) - mu/(2 lam) sqrt(4 mu lam y + mu^2 y^2),
    y = nu^2, accepted when u <= mu/(mu+x), else mu^2/x. The expression
    and its order of operations are the reference's; the square root is
    correctly rounded (``rng.sqrt_rn``), as XLA's and the kernel's are."""
    y = nu * nu
    muy = mu * y
    x = mu + mu * muy / (2.0 * lam) - (mu / (2.0 * lam)) * rng.sqrt_rn(
        4.0 * mu * lam * y + muy * muy)
    # Guard the fp edge where the sqrt slightly overshoots mu.
    x = torch.clamp_min(x, torch.finfo(mu.dtype).tiny)
    return torch.where(u <= mu / (mu + x), x, mu * mu / x)


def ig_gamma_from_noise(residual: torch.Tensor, nu: torch.Tensor,
                        u: torch.Tensor, eps: float) -> torch.Tensor:
    """Gibbs gamma update from pre-drawn noise (paper Eq. 5, clamped):
    gamma^{-1} ~ IG(1/|residual|, 1) through ``ig_transform``. Float32,
    or float64 for float64 inputs."""
    r = residual.abs()
    if r.dtype != torch.float64:
        r = r.float()
    mu = torch.clamp_max(1.0 / torch.clamp_min(r, 1.0 / _MU_MAX), _MU_MAX)
    inv_gamma = ig_transform(mu, nu.to(r.dtype), u.to(r.dtype))
    return torch.clamp_min(1.0 / torch.clamp_min(inv_gamma, 1.0 / _MU_MAX),
                           eps)


def check_epilogue(epilogue: str) -> None:
    """Raise for an unknown epilogue name."""
    if epilogue not in EPILOGUES:
        raise ValueError(f"epilogue must be one of {EPILOGUES}, "
                         f"got {epilogue!r}")


def apply_epilogue(epilogue: str, margin, rho, beta, noise, eps: float,
                   eps_ins: float = 0.0):
    """-> (aug, sigma_weight, coef) for float tensors aligned with
    ``margin``. em_hinge: gamma = max(eps, |rho - margin|) (paper Eq. 9/36
    and the Sec 5.7.3 clamp); mc_hinge: the Gibbs draw from ``noise`` =
    (nu, u). Both weigh Sigma by 1/gamma, with coef rho/gamma + beta.

    SVR (``rho`` is the target y, ``beta`` unused), with res = rho -
    margin: em_svr gamma = max(eps, |res - eps_ins|), omega = max(eps,
    |res + eps_ins|); mc_svr draws gamma from res - eps_ins with (nu_g,
    u_g) and omega from res + eps_ins with (nu_o, u_o), ``noise`` in that
    order. Weight 1/gamma + 1/omega, coef (rho - eps_ins)/gamma +
    (rho + eps_ins)/omega."""
    check_epilogue(epilogue)
    if epilogue in ("em_hinge", "mc_hinge"):
        if epilogue == "em_hinge":
            gamma = (rho - margin).abs().clamp_min(eps)
        else:
            nu, u = noise
            gamma = ig_gamma_from_noise(rho - margin, nu, u, eps)
        return (gamma,), 1.0 / gamma, rho / gamma + beta
    res = rho - margin
    if epilogue == "em_svr":
        gamma = (res - eps_ins).abs().clamp_min(eps)
        omega = (res + eps_ins).abs().clamp_min(eps)
    else:
        nu_g, u_g, nu_o, u_o = noise
        gamma = ig_gamma_from_noise(res - eps_ins, nu_g, u_g, eps)
        omega = ig_gamma_from_noise(res + eps_ins, nu_o, u_o, eps)
    weight = 1.0 / gamma + 1.0 / omega
    coef = (rho - eps_ins) / gamma + (rho + eps_ins) / omega
    return (gamma, omega), weight, coef
