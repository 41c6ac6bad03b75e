"""Architecture configs (one module per assigned arch) + shape table: the
port's own copy of ``repro/configs``, field for field."""
import importlib

from .base import (  # noqa: F401
    SHAPES, ModelConfig, ShapeConfig, applicable, get_config, list_archs,
    register)

_MODULES = [
    "yi_34b", "granite_3_2b", "smollm_135m", "deepseek_67b",
    "granite_moe_1b_a400m", "deepseek_v2_236b", "jamba_v0_1_52b",
    "xlstm_350m", "qwen2_vl_72b", "whisper_small", "svm_paper",
]

_loaded = False


def _load_all():
    global _loaded
    if _loaded:
        return
    for m in _MODULES:
        importlib.import_module(f"repro_torch.configs.{m}")
    _loaded = True
