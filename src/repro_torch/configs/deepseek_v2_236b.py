"""DeepSeek-V2-236B: MLA (kv_lora=512) + MoE 2 shared + 160 routed top-6
[arXiv:2405.04434; hf].

Assignment table lists GQA kv=128 (i.e. MHA head count) and d_ff=1536 (the
per-expert hidden dim); MLA replaces the KV cache with a 512-dim latent."""
from .base import ModelConfig, register


@register("deepseek-v2-236b")
def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-236b", family="moe",
        n_layers=60, d_model=5120, n_heads=128, n_kv_heads=128, head_dim=128,
        d_ff=12288, vocab=102400,
        n_experts=160, n_shared_experts=2, top_k=6, moe_d_ff=1536,
        moe_every=1, moe_offset=0,
        mla=True, kv_lora_rank=512, q_lora_rank=1536,
        qk_rope_dim=64, qk_nope_dim=128, v_head_dim=128,
        source="arXiv:2405.04434; hf",
    )
