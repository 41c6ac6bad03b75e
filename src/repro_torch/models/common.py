"""Shared model building blocks: norms, initializers, dtype policy
(``repro/models/common.py`` in PyTorch).

The initializers draw through ``core.prng``, the port's copy of the
reference's ``jax.random`` stream, so one key gives the reference's
weights to a few ulp."""
from __future__ import annotations

import torch

from repro_torch.core import prng


def compute_dtype(cfg) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float
             ) -> torch.Tensor:
    """In float32, cast back to x's dtype."""
    xf = x.float()
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * scale.float()
    return out.to(x.dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    xf = x.float()
    mean = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, correction=0)
    out = (xf - mean) * torch.rsqrt(var + eps)
    out = out * scale.float() + bias.float()
    return out.to(x.dtype)


def dense_init(key: torch.Tensor, in_dim: int, out_dim: int, *,
               scale: float = 1.0) -> torch.Tensor:
    """Truncated-normal fan-in init (LLM standard), float32."""
    std = scale / (in_dim ** 0.5)
    return std * prng.truncated_normal(key, -2.0, 2.0, (in_dim, out_dim))


def embed_init(key: torch.Tensor, vocab: int, dim: int) -> torch.Tensor:
    return prng.truncated_normal(key, -2.0, 2.0, (vocab, dim)) * 0.02


def chunk_len(S: int, chunk: int) -> int:
    """The chunk a sequence pass of S steps takes: ``chunk`` (at most S),
    or S itself where ``chunk`` does not divide it (odd test shapes)."""
    c = min(chunk, S)
    return S if S % c else c


def split_keys(key: torch.Tensor, n: int) -> list[torch.Tensor]:
    return list(prng.split(key, n))
