"""Pegasos: Primal Estimated sub-GrAdient SOlver for SVM [14 in paper]
(``repro/baselines/pegasos.py`` in PyTorch).

Mini-batch projected sub-gradient descent on the paper's objective Eq. 1
(with lambda as the L2 coefficient). Step t uses eta_t = 1/(lambda * t),
t float32 as in the reference, and the optional ball projection
||w|| <= 1/sqrt(lambda). The keys are ``split(PRNGKey(seed), n_steps)``
and each step's rows ``randint(key, (B,), 0, N)``, bitwise the
reference's; all steps' indices are drawn at once on the device, then the
steps run as plain torch ops (a 256-row gather and two products: no
kernel of their own).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.core.solver import _device

from .common import LinearRule, design, labels

# Indices drawn at once: bounds the draw's int64 temporaries.
_DRAW = 1 << 22


def batch_indices(seed: int, n_steps: int, batch: int, N: int,
                  device) -> torch.Tensor:
    """(n_steps, batch) int64 row indices: step t's ``randint(keys[t],
    (batch,), 0, N)`` with ``keys = split(PRNGKey(seed), n_steps)``."""
    keys = prng.split(prng.PRNGKey(seed, device=device), n_steps)
    per = max(1, _DRAW // batch)
    return torch.cat([prng.randint(keys[s:s + per], (batch,), 0, N).long()
                      for s in range(0, n_steps, per)])


def pegasos_step(X: torch.Tensor, y: torch.Tensor, w: torch.Tensor,
                 idx: torch.Tensor, t: torch.Tensor, lam: float,
                 project: bool) -> torch.Tensor:
    """One step of the reference's scan: the sub-gradient of the hinge on
    rows ``idx``, eta = 1 / (lam t) (``t`` a float32 0-d tensor), and the
    ball projection under ``project``."""
    xb, yb = X[idx], y[idx]
    margin = yb * (xb @ w)
    scale = float(np.float32(2.0 / idx.shape[0]))
    g_loss = -(xb * (yb * (margin < 1.0))[:, None]).sum(0) * scale
    eta = 1.0 / (lam * t)
    w = (1.0 - eta * lam) * w - eta * g_loss
    if project:
        sqrt_lam = torch.sqrt(torch.tensor(lam, dtype=torch.float32,
                                           device=w.device))
        norm = torch.linalg.vector_norm(w)
        w = w * torch.clamp(1.0 / (sqrt_lam * norm + 1e-30), max=1.0)
    return w


@dataclasses.dataclass
class PegasosSVM(LinearRule):
    lam: float = 1.0
    n_steps: int = 2000
    batch_size: int = 256
    project: bool = True
    seed: int = 0
    add_bias: bool = True
    device: object = None

    def fit(self, X, y) -> "PegasosSVM":
        dev = _device(self.device, "PegasosSVM")
        X = design(X, self.add_bias, dev)
        y = labels(y, dev)
        N, K = X.shape
        idx = batch_indices(self.seed, self.n_steps,
                            min(self.batch_size, N), N, dev)
        ts = torch.arange(1, self.n_steps + 1, dtype=torch.float32,
                          device=dev)
        w = torch.zeros(K, dtype=torch.float32, device=dev)
        for t in range(self.n_steps):
            w = pegasos_step(X, y, w, idx[t], ts[t], self.lam, self.project)
        self.w = w
        return self
