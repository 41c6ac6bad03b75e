"""Whisper-small transformer backbone: encoder-decoder, conv audio
frontend stubbed to precomputed frame embeddings
[arXiv:2212.04356; unverified]."""
from .base import ModelConfig, register


@register("whisper-small")
def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-small", family="audio",
        n_layers=12, d_model=768, n_heads=12, n_kv_heads=12, head_dim=64,
        d_ff=3072, vocab=51865,
        enc_dec=True, n_enc_layers=12, enc_seq=1500,
        frontend="audio", use_bias=True, tie_embeddings=True,
        source="arXiv:2212.04356; unverified",
    )
