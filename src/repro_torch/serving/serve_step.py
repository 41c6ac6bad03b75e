"""Serve-step builders: prefill and single-token decode
(``repro/serving/serve_step.py``).

The model holds its parameters, so the steps take no ``params``. Tokens
stay on the model's device from step to step; ``generate`` copies the
result to the host once, at the end."""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core import prng

from . import sampler


def make_prefill_step(model, cache_len: int) -> Callable:
    """(batch) -> (next_token (B,), caches)."""
    def prefill_step(batch):
        logits, caches = model.prefill(batch, cache_len)
        return sampler.greedy(logits), caches
    return prefill_step


def make_decode_step(model, *, temp: float = 0.0, top_k: int = 0
                     ) -> Callable:
    """(tokens (B, 1), pos, caches[, key]) -> (next_token (B,), logits,
    caches); ``key`` is a ``core.prng`` key, used when temp > 0."""
    def decode_step(tokens, pos, caches, key=None):
        logits, caches = model.decode(tokens, pos, caches)
        lg = logits[:, -1, :]
        if temp > 0.0:
            tok = sampler.temperature(key.to(lg.device), lg, temp, top_k)
        else:
            tok = sampler.greedy(lg)
        return tok, lg, caches
    return decode_step


def generate(model, batch, *, steps: int, cache_len: int, temp: float = 0.0,
             top_k: int = 0, seed: int = 0) -> torch.Tensor:
    """(B, steps) int32 tokens on the host: the prefill's token, then
    steps - 1 decode steps at positions prompt_len + i. The key is split
    at every step, greedy or not, as the reference splits it; the key
    chain runs on the host (two words a step) and a step's key goes to
    the device only when it samples."""
    prefill = make_prefill_step(model, cache_len)
    decode = make_decode_step(model, temp=temp, top_k=top_k)
    tok, caches = prefill(batch)
    prompt_len = int(batch["tokens"].shape[1])
    out = torch.empty((tok.shape[0], steps), dtype=torch.int32,
                      device=tok.device)
    out[:, 0] = tok
    key = prng.PRNGKey(seed)
    for i in range(steps - 1):
        key, sub = prng.split(key)
        tok, _, caches = decode(tok[:, None], prompt_len + i, caches, sub)
        out[:, i + 1] = tok
    return out.cpu()
