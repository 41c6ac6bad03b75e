"""Qwen2-VL-72B language backbone: GQA + M-RoPE, dynamic-resolution vision
stubbed to precomputed patch embeddings [arXiv:2409.12191; hf]."""
from .base import ModelConfig, register


@register("qwen2-vl-72b")
def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-72b", family="vlm",
        n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
        d_ff=29568, vocab=152064, rope_theta=1e6,
        mrope=True, mrope_sections=(16, 24, 24), frontend="vision",
        source="arXiv:2409.12191; hf",
    )
