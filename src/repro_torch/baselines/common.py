"""What the two baselines share: the design matrix with its bias column
on the device, and the linear decision rule."""
from __future__ import annotations

import numpy as np
import torch


def design(X, add_bias: bool, device: torch.device) -> torch.Tensor:
    """X as a float32 (N, K [+ 1]) tensor on ``device``, with a column of
    ones appended under ``add_bias``."""
    X = torch.as_tensor(np.asarray(X, np.float32) if not isinstance(
        X, torch.Tensor) else X).to(device, torch.float32)
    if add_bias:
        X = torch.cat([X, torch.ones((X.shape[0], 1), dtype=X.dtype,
                                     device=device)], 1)
    return X.contiguous()


def labels(y, device: torch.device) -> torch.Tensor:
    """y as a float32 (N,) tensor on ``device``."""
    return torch.as_tensor(np.asarray(y) if not isinstance(
        y, torch.Tensor) else y).to(device, torch.float32).contiguous()


class LinearRule:
    """decision_function / predict / score of a fitted weight ``w`` (a
    (K,) tensor on ``device``, the bias last under ``add_bias``)."""
    w: torch.Tensor
    add_bias: bool
    device: torch.device

    def decision_function(self, X) -> torch.Tensor:
        return design(X, self.add_bias, self.w.device) @ self.w

    def predict(self, X) -> torch.Tensor:
        d = self.decision_function(X)
        return torch.where(d >= 0, 1, -1)

    def score(self, X, y) -> float:
        y = torch.as_tensor(np.asarray(y) if not isinstance(
            y, torch.Tensor) else y).to(self.w.device)
        return float(torch.mean((self.predict(X) == y).double()))
