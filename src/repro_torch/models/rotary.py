"""Rotary position embeddings (``repro/models/rotary.py``'s RoPE in
PyTorch): the half-split (NeoX) rotation, in float32. M-RoPE waits for
the VLM family (ROADMAP item 13c)."""
from __future__ import annotations

import torch


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """(head_dim/2,) inverse frequencies."""
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (B, S, H, D); positions: (B, S) int -> rotated x."""
    D = x.shape[-1]
    inv = rope_freqs(D, theta, x.device)                      # (D/2,)
    ang = positions.float()[..., None] * inv                  # (B, S, D/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)
    return out.to(x.dtype)
