"""Model zoo: the dense and MoE GQA decoders behind the reference's
facade (``build_model`` / ``Model``). The other families are ROADMAP
item 13c."""
from .model import Model, build_model  # noqa: F401
