"""Granite-3.0-1B-A400M: 32-expert top-8 MoE
[hf:ibm-granite/granite-3.0-1b-a400m-base]."""
from .base import ModelConfig, register


@register("granite-moe-1b-a400m")
def config() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-1b-a400m", family="moe",
        n_layers=24, d_model=1024, n_heads=16, n_kv_heads=8, head_dim=64,
        d_ff=512, vocab=49155, tie_embeddings=True,
        n_experts=32, top_k=8, moe_d_ff=512,
        source="hf:ibm-granite/granite-3.0-1b-a400m-base",
    )
