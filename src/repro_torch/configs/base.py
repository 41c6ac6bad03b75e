"""Config schema for the assigned architectures and input shapes.

Every architecture in the assignment table gets a ``ModelConfig`` in its
own module (src/repro_torch/configs/<id>.py) registered under its
``--arch`` id.
``ShapeConfig`` encodes the four assigned input shapes; applicability of
``long_500k`` / decode shapes is derived from the architecture family
(DESIGN.md §4)."""
from __future__ import annotations

import dataclasses
from typing import Callable


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | hybrid | ssm | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 128
    # --- MoE
    n_experts: int = 0          # routed experts (0 = dense)
    n_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0           # per-expert hidden dim
    moe_every: int = 1          # MoE block on layers l % moe_every == moe_offset
    moe_offset: int = 0
    moe_capacity_factor: float = 1.25  # GShard-style drop policy
    # --- MLA (deepseek-v2)
    mla: bool = False
    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    qk_rope_dim: int = 64
    qk_nope_dim: int = 128
    v_head_dim: int = 128
    # --- hybrid (jamba): attention on layers l % attn_every == attn_offset
    attn_every: int = 0         # 0 = attention everywhere
    attn_offset: int = 0
    mamba_d_state: int = 16
    mamba_d_conv: int = 4
    mamba_expand: int = 2
    mamba_dt_rank: int = 0      # 0 -> ceil(d_model/16)
    # --- xLSTM: sLSTM on layers l % slstm_every == slstm_offset
    slstm_every: int = 0        # 0 = no sLSTM (all mLSTM)
    slstm_offset: int = 0
    lstm_expand: int = 2
    # --- encoder-decoder (whisper)
    enc_dec: bool = False
    n_enc_layers: int = 0
    enc_seq: int = 1500         # whisper 30s @ 50Hz after conv stride 2
    # --- VLM
    mrope: bool = False
    mrope_sections: tuple[int, ...] = (16, 24, 24)   # pairs of head_dim/2
    frontend: str | None = None  # 'audio' | 'vision' stubs (embeddings input)
    # --- common
    rope_theta: float = 1e4
    norm_eps: float = 1e-5
    use_bias: bool = False
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    source: str = ""            # provenance tag from the assignment table

    # ------------------------------------------------------------- derived
    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def subquadratic(self) -> bool:
        """Eligible for long_500k (SSM / hybrid)."""
        return self.family in ("ssm", "hybrid")

    @property
    def layer_period(self) -> int:
        """Homogeneous layer-group size for scan-over-layers."""
        import math
        p = 1
        if self.attn_every:
            p = math.lcm(p, self.attn_every)
        if self.moe_every > 1:
            p = math.lcm(p, self.moe_every)
        if self.slstm_every:
            p = math.lcm(p, self.slstm_every)
        return p

    @property
    def d_inner(self) -> int:           # mamba / xlstm inner width
        return self.mamba_expand * self.d_model if self.family == "hybrid" \
            else self.lstm_expand * self.d_model

    @property
    def dt_rank(self) -> int:
        return self.mamba_dt_rank or -(-self.d_model // 16)

    def is_attn_layer(self, layer: int) -> bool:
        if self.family == "ssm":
            return False
        if not self.attn_every:
            return True
        return layer % self.attn_every == self.attn_offset

    def is_moe_layer(self, layer: int) -> bool:
        if not self.n_experts:
            return False
        return layer % self.moe_every == self.moe_offset

    def is_slstm_layer(self, layer: int) -> bool:
        if not self.slstm_every:
            return False
        return layer % self.slstm_every == self.slstm_offset

    def num_params(self) -> int:
        """Analytic parameter count (used for 6ND roofline MODEL_FLOPS)."""
        d, V = self.d_model, self.vocab
        total = V * d  # embedding
        if not self.tie_embeddings:
            total += V * d
        for l in range(self.n_layers):
            if self.is_attn_layer(l):
                if self.mla:
                    qd = (self.qk_rope_dim + self.qk_nope_dim)
                    total += d * self.q_lora_rank if self.q_lora_rank else 0
                    qin = self.q_lora_rank or d
                    total += qin * self.n_heads * qd
                    total += d * (self.kv_lora_rank + self.qk_rope_dim)
                    total += self.kv_lora_rank * self.n_heads * (
                        self.qk_nope_dim + self.v_head_dim)
                    total += self.n_heads * self.v_head_dim * d
                else:
                    total += d * self.n_heads * self.head_dim * 2  # q, o
                    total += d * self.n_kv_heads * self.head_dim * 2
            elif self.family == "hybrid":  # mamba block
                di, ds, dc = self.d_inner, self.mamba_d_state, self.mamba_d_conv
                total += d * 2 * di + di * dc + di * (self.dt_rank + 2 * ds)
                total += self.dt_rank * di + di * ds + di + di * d
            if self.family == "ssm":
                di = self.d_inner
                hd = di // self.n_heads
                if self.is_slstm_layer(l):
                    total += 4 * d * d + 4 * self.n_heads * (d // self.n_heads) ** 2
                else:
                    total += d * 2 * di + 3 * di * di // self.n_heads + di * d
                total += 2 * d  # norms
                continue
            if self.is_moe_layer(l):
                e = self.n_experts + self.n_shared_experts
                total += e * 3 * d * self.moe_d_ff + d * self.n_experts
            elif self.d_ff:
                mult = 2 if self.use_bias else 3  # gelu mlp vs swiglu
                total += mult * d * self.d_ff
            total += 2 * d  # norms
        if self.enc_dec:
            for _ in range(self.n_enc_layers):
                total += d * self.n_heads * self.head_dim * 4
                total += 2 * d * self.d_ff + 2 * d
            # decoder cross-attention
            total += self.n_layers * (d * self.n_heads * self.head_dim * 4 + d)
            total += self.enc_seq * d  # encoder positions
        total += d  # final norm
        return total

    def active_params(self) -> int:
        """Active (per-token) params for MoE 6ND accounting."""
        if not self.n_experts:
            return self.num_params()
        full_moe = self.n_experts * 3 * self.d_model * self.moe_d_ff
        act_moe = (self.top_k) * 3 * self.d_model * self.moe_d_ff
        n_moe_layers = sum(self.is_moe_layer(l) for l in range(self.n_layers))
        return self.num_params() - n_moe_layers * (full_moe - act_moe)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                   # 'train' | 'prefill' | 'decode'


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def applicable(cfg: ModelConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """(runs, reason-if-skipped) for an (arch, shape) cell."""
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False, ("full-attention architecture: 500k-token cache is "
                       "quadratic-regime; skipped per assignment note")
    return True, ""


_REGISTRY: dict[str, Callable[[], ModelConfig]] = {}


def register(arch_id: str):
    def deco(fn):
        _REGISTRY[arch_id] = fn
        return fn
    return deco


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in _REGISTRY:
        # import config modules lazily on first miss
        from . import _load_all
        _load_all()
    if arch_id not in _REGISTRY:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[arch_id]()


def list_archs() -> list[str]:
    from . import _load_all
    _load_all()
    return sorted(_REGISTRY)
