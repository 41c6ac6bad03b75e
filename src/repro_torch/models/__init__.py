"""Model zoo: every assigned family (dense, MoE, MLA, the Jamba hybrid,
xLSTM, the VLM, the encoder-decoder) behind the reference's facade
(``build_model`` / ``Model``)."""
from .model import Model, build_model  # noqa: F401
