"""Feed-forward block of the dense family: SwiGLU
(``repro/models/mlp.py``). The GELU MLP and MoE wait for their families
(ROADMAP item 13c)."""
from __future__ import annotations

import torch.nn.functional as F

from .common import dense_init, split_keys


def init_swiglu(key, d_model: int, d_ff: int, n_layers: int) -> dict:
    ks = split_keys(key, 3)
    return {
        "w_gate": dense_init(ks[0], d_model, d_ff),
        "w_up": dense_init(ks[1], d_model, d_ff),
        "w_down": dense_init(ks[2], d_ff, d_model,
                             scale=1.0 / (2 * n_layers) ** 0.5),
    }


def swiglu(p: dict, x):
    """``p`` holds the weights in x's dtype."""
    g = F.silu(x @ p["w_gate"])
    u = x @ p["w_up"]
    return (g * u) @ p["w_down"]
