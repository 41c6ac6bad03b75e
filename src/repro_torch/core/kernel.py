"""Kernel Gram blocks for the KRN formulation (paper Sec 3.1): port of
``gram_matrix`` from ``repro/core/kernel.py``.

``rbf`` goes through ``ops.rbf_gram`` (the hand-written kernel on a CUDA
tensor), ``linear`` is a plain product, as in the reference. The
exact-Gram solver (``krn_step``, ``pad_gram``, the exact-Gram
``decision_function``) is ROADMAP queue 1 item 9.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops


def gram_matrix(X1: torch.Tensor, X2: torch.Tensor, *, kind: str = "rbf",
                sigma: float = 1.0, backend: str | None = None
                ) -> torch.Tensor:
    """Gram block (N1, N2) float32 between two sets of rows."""
    if kind == "rbf":
        return ops.rbf_gram(X1, X2, sigma=sigma, backend=backend)
    if kind == "linear":
        return X1.to(torch.float32) @ X2.to(torch.float32).T
    raise ValueError(f"unknown kernel kind {kind!r}")
