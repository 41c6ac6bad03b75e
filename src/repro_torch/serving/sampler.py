"""Token samplers for the serving path (``repro/serving/sampler.py``)."""
from __future__ import annotations

import torch

from repro_torch.core import prng


def greedy(logits: torch.Tensor) -> torch.Tensor:
    """logits: (B, V) -> (B,) int32, the first maximal index."""
    return torch.argmax(logits, dim=-1).to(torch.int32)


def temperature(key: torch.Tensor, logits: torch.Tensor, temp: float = 1.0,
                top_k: int = 0) -> torch.Tensor:
    """One draw a row from softmax(logits / temp), restricted to the top_k
    logits when top_k > 0; ``key`` is a ``core.prng`` key on the logits'
    device, and the draw is ``jax.random.categorical``'s for that key."""
    lg = logits.float() / max(temp, 1e-6)
    if top_k:
        kth = torch.sort(lg, dim=-1).values[:, -top_k][:, None]
        lg = torch.where(lg < kth, -1e30, lg)
    return prng.categorical(key, lg).to(torch.int32)
