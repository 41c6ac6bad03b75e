"""Per-row augmentation epilogues: what sits between the margin and the
(b, Sigma) accumulators of the fused statistic.

Port of ``repro/kernels/epilogues.py``. Only ``em_hinge`` is ported; the
CUDA kernels carry the same arithmetic as ``__device__`` code
(``csrc/fused_stats.cu``, ``csrc/fused_estep.cu``).

Epilogue contract: ``apply_epilogue`` maps the margin to
(aug, sigma_weight, coef) where aug = (gamma,) for the hinge,
Sigma = X^T diag(wmask * sigma_weight) X and b = X^T coef.
"""
from __future__ import annotations

EPILOGUES = ("em_hinge", "mc_hinge", "em_svr", "mc_svr")

# (nu, u) operand pairs consumed per row: one per IG mixture drawn.
_NOISE_ARITY = {"em_hinge": 0, "mc_hinge": 2, "em_svr": 0, "mc_svr": 4}

_NOT_PORTED = {
    "mc_hinge": "ROADMAP queue 1 item 5 (LIN-MC-CLS)",
    "em_svr": "ROADMAP queue 1 item 6 (SVR)",
    "mc_svr": "ROADMAP queue 1 item 6 (SVR)",
}


def noise_arity(epilogue: str) -> int:
    """Number of pre-drawn (N,) noise operands the epilogue consumes."""
    return _NOISE_ARITY[epilogue]


def check_ported(epilogue: str) -> None:
    """Raise for an epilogue this port does not carry yet."""
    if epilogue in _NOT_PORTED:
        raise NotImplementedError(
            f"epilogue {epilogue!r} is not ported yet: "
            f"{_NOT_PORTED[epilogue]}")
    if epilogue not in EPILOGUES:
        raise ValueError(f"epilogue must be one of {EPILOGUES}, "
                         f"got {epilogue!r}")


def apply_epilogue(epilogue: str, margin, rho, beta, noise, eps: float,
                   eps_ins: float = 0.0):
    """-> (aug, sigma_weight, coef) for float tensors aligned with
    ``margin``. em_hinge: gamma = max(eps, |rho - margin|) (paper Eq. 9/36
    and the Sec 5.7.3 clamp), weight 1/gamma, coef rho/gamma + beta."""
    del noise, eps_ins  # em_hinge draws nothing and has no tube
    check_ported(epilogue)
    gamma = (rho - margin).abs().clamp_min(eps)
    return (gamma,), 1.0 / gamma, rho / gamma + beta
