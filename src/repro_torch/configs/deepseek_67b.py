"""DeepSeek-67B: dense llama-arch GQA [arXiv:2401.02954; hf]."""
from .base import ModelConfig, register


@register("deepseek-67b")
def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-67b", family="dense",
        n_layers=95, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
        d_ff=22016, vocab=102400, rope_theta=1e4,
        source="arXiv:2401.02954; hf",
    )
