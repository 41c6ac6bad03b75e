"""MaxMarginHead: the paper's composite max-margin model (Sec 1) over a
frozen backbone, ``repro/core/head.py`` in PyTorch.

    features h = pool(backbone(tokens))  (B, F)   -- e.g. repro_torch.models
    head     fitted by PEMSVM's parallel EM/MCMC

``feature_fn`` runs under ``torch.inference_mode()`` (the reference jits
it) on batches of ``feature_batch`` inputs placed on the head's device;
the features come back to the host once, and ``PEMSVM`` fits on them
through its kernels on the card. ``mesh`` and ``data_axes`` pass through
to ``PEMSVM``: every rank extracts the same features and the fit reduces
over the mesh's data axes."""
from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

from .solver import PEMSVM, SVMConfig


def mean_pool(hidden: torch.Tensor, mask: torch.Tensor | None = None
              ) -> torch.Tensor:
    """(B, T, D) -> (B, D) masked mean over tokens."""
    if mask is None:
        return torch.mean(hidden, dim=1)
    m = mask[..., None].to(hidden.dtype)
    return torch.sum(hidden * m, dim=1) / torch.sum(m, dim=1).clamp_min(1.0)


def last_token_pool(hidden: torch.Tensor, lengths: torch.Tensor
                    ) -> torch.Tensor:
    """(B, T, D) -> (B, D) hidden state at the last valid position."""
    idx = torch.clamp(lengths.long() - 1, 0, hidden.shape[1] - 1)
    return hidden[torch.arange(hidden.shape[0], device=hidden.device), idx]


class MaxMarginHead:
    """PEMSVM readout over backbone features.

    feature_fn: (B, ...) tensor on the head's device -> (B, F) pooled
    features, frozen parameters closed over. Fitting extracts features in
    batches, then runs the parallel SVM (on ``mesh`` when given)."""

    def __init__(self, config: SVMConfig, feature_fn: Callable,
                 mesh=None, data_axes: Sequence[str] | None = None,
                 feature_batch: int = 256, device=None):
        self.svm = PEMSVM(config, device=device, mesh=mesh,
                          data_axes=data_axes)
        self.feature_fn = feature_fn
        self.feature_batch = feature_batch

    @property
    def device(self) -> torch.device:
        return self.svm.device

    def extract(self, inputs: np.ndarray) -> np.ndarray:
        feats = []
        with torch.inference_mode():
            for i in range(0, len(inputs), self.feature_batch):
                x = torch.as_tensor(np.asarray(
                    inputs[i:i + self.feature_batch])).to(self.device)
                feats.append(self.feature_fn(x))
            return torch.cat(feats).cpu().numpy()

    def fit(self, inputs: np.ndarray, y: np.ndarray):
        return self.svm.fit(self.extract(inputs), y)

    def predict(self, inputs: np.ndarray) -> np.ndarray:
        return self.svm.predict(self.extract(inputs))

    def score(self, inputs: np.ndarray, y: np.ndarray) -> float:
        """Higher-is-better (accuracy, or negated RMSE for SVR) -- see
        ``PEMSVM.score``."""
        return self.svm.score(self.extract(inputs), y)

    def rmse(self, inputs: np.ndarray, y: np.ndarray) -> float:
        return self.svm.rmse(self.extract(inputs), y)
