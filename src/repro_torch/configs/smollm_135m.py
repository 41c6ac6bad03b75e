"""SmolLM-135M: small llama-arch GQA [hf:HuggingFaceTB/SmolLM-135M].

Also the ~100M-class model used by the end-to-end training example."""
from .base import ModelConfig, register


@register("smollm-135m")
def config() -> ModelConfig:
    return ModelConfig(
        name="smollm-135m", family="dense",
        n_layers=30, d_model=576, n_heads=9, n_kv_heads=3, head_dim=64,
        d_ff=1536, vocab=49152, rope_theta=1e4, tie_embeddings=True,
        source="hf:HuggingFaceTB/SmolLM-135M",
    )
