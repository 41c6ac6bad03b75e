"""xLSTM-350M: mLSTM blocks with periodic sLSTM blocks
[arXiv:2405.04517; unverified].

Assignment: 24L d_model=1024 4H d_ff=0 (projections live inside the
blocks). sLSTM on l % 6 == 5 (4 of 24; ~7:1 mLSTM:sLSTM)."""
from .base import ModelConfig, register


@register("xlstm-350m")
def config() -> ModelConfig:
    return ModelConfig(
        name="xlstm-350m", family="ssm",
        n_layers=24, d_model=1024, n_heads=4, n_kv_heads=4, head_dim=256,
        d_ff=0, vocab=50304, lstm_expand=2,
        slstm_every=6, slstm_offset=5,
        source="arXiv:2405.04517; unverified",
    )
