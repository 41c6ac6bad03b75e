"""Jamba-v0.1-52B: hybrid Mamba+attention (1:7 interleave) with 16-expert
top-2 MoE every other layer [arXiv:2403.19887; hf].

Layer l is attention iff l % 8 == 4 (4 of 32); MoE iff l % 2 == 1."""
from .base import ModelConfig, register


@register("jamba-v0.1-52b")
def config() -> ModelConfig:
    return ModelConfig(
        name="jamba-v0.1-52b", family="hybrid",
        n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
        d_ff=14336, vocab=65536,
        n_experts=16, top_k=2, moe_d_ff=14336, moe_every=2, moe_offset=1,
        attn_every=8, attn_offset=4,
        mamba_d_state=16, mamba_d_conv=4, mamba_expand=2,
        source="arXiv:2403.19887; hf",
    )
