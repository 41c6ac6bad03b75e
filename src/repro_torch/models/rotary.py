"""Rotary position embeddings (``repro/models/rotary.py`` in PyTorch):
standard RoPE and Qwen2-VL's M-RoPE, the half-split (NeoX) rotation in
float32.

M-RoPE (arXiv:2409.12191): the head_dim/2 frequency pairs are split into
sections (temporal, height, width); each section rotates by its own
position stream. The angles are formed in the same contiguous (B, S, D/2)
layout as RoPE's, from the same float32 products, so with t = h = w
(text) M-RoPE is RoPE bit for bit."""
from __future__ import annotations

import torch


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """(head_dim/2,) inverse frequencies."""
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def _rotate(x: torch.Tensor, ang: torch.Tensor) -> torch.Tensor:
    """x (B, S, H, D) rotated by the angles ang (B, S, D/2), in float32,
    cast back to x's dtype."""
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (B, S, H, D); positions: (B, S) int -> rotated x."""
    inv = rope_freqs(x.shape[-1], theta, x.device)            # (D/2,)
    return _rotate(x, positions.float()[..., None] * inv)     # (B, S, D/2)


def apply_mrope(x: torch.Tensor, positions3: torch.Tensor, theta: float,
                sections: tuple[int, ...]) -> torch.Tensor:
    """x: (B, S, H, D); positions3: (3, B, S) (t, h, w) position streams;
    sections: frequency-pair counts per stream, sum == D/2."""
    D = x.shape[-1]
    if sum(sections) != D // 2:
        raise ValueError(f"M-RoPE sections {tuple(sections)} do not sum to "
                         f"head_dim / 2 = {D // 2}")
    inv = rope_freqs(D, theta, x.device)                      # (D/2,)
    # each pair's stream: section s repeated sections[s] times
    stream = torch.repeat_interleave(
        torch.arange(len(sections), device=x.device),
        torch.tensor(sections, device=x.device))
    pos = positions3.float().permute(1, 2, 0)[..., stream]    # (B, S, D/2)
    return _rotate(x, pos * inv)
