"""Dual coordinate descent for the L1-loss linear SVM — the LibLinear
"LL-Dual" solver the paper benchmarks against [5 in paper; Hsieh et al.
2008] (``repro/baselines/dcd.py`` in PyTorch).

Solves  min_alpha 1/2 a^T Q a - sum(a),  0 <= a_i <= C,
Q_ij = y_i y_j x_i x_j, maintaining w = sum a_i y_i x_i. The paper's
objective Eq. 1 (1/2 lam ||w||^2 + 2 sum xi) is proportional to the
standard form with C = 2/lam, so minimizers coincide.

Coordinates are swept in a fixed random permutation per epoch, the
reference's own (``np.random.default_rng(seed).permutation`` per epoch),
copied to the device once; the whole sweep is one launch of the
``kernels/dcd.py`` kernel (the algorithm is inherently sequential: this is
the single-threaded baseline, exactly the role it plays in the paper's
tables).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.solver import _device
from repro_torch.kernels import dcd as dcd_kernel

from .common import LinearRule, design, labels


def permutations(seed: int, N: int, n_epochs: int) -> np.ndarray:
    """The reference's sweep order: one permutation of the N rows an
    epoch from ``default_rng(seed)``, flat, int32."""
    rng = np.random.default_rng(seed)
    return np.stack([rng.permutation(N) for _ in range(n_epochs)]
                    ).reshape(-1).astype(np.int32)


@dataclasses.dataclass
class DCDSVM(LinearRule):
    C: float = 1.0
    n_epochs: int = 10
    seed: int = 0
    add_bias: bool = True
    device: object = None

    @classmethod
    def from_lam(cls, lam: float, **kw) -> "DCDSVM":
        return cls(C=2.0 / lam, **kw)

    def fit(self, X, y) -> "DCDSVM":
        dev = _device(self.device, "DCDSVM")
        X = design(X, self.add_bias, dev)
        y = labels(y, dev)
        qdiag = torch.sum(X * X, dim=1)
        order = torch.from_numpy(permutations(self.seed, X.shape[0],
                                              self.n_epochs)).to(dev)
        self.w, self.alpha = dcd_kernel.dcd_sweep(
            X, y, qdiag, order, float(np.float32(self.C)))
        return self
