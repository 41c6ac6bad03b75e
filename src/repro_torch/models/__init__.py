"""Model zoo: the decoder-only families (dense, MoE, MLA, the Jamba
hybrid, xLSTM) behind the reference's facade (``build_model`` /
``Model``). The VLM and the encoder-decoder are ROADMAP item 13c."""
from .model import Model, build_model  # noqa: F401
