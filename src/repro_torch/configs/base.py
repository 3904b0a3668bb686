"""Model and input-shape configuration dataclasses.

Every assigned architecture is described by a single `ModelConfig`; the four
assignment input shapes by `ShapeConfig`. Configs are plain frozen dataclasses
so they hash/compare and can key jit caches.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // num_heads

    # ---- attention variants ----
    attn_bias: bool = False            # qwen2-style QKV bias
    sliding_window: int = 0            # 0 = full attention; >0 = SWA window
    rope_theta: float = 10_000.0

    # ---- MLA (DeepSeek-V2 multi-head latent attention) ----
    use_mla: bool = False
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128

    # ---- MoE ----
    num_experts: int = 0               # routed experts (0 = dense MLP)
    num_experts_per_tok: int = 0
    num_shared_experts: int = 0
    moe_d_ff: int = 0                  # per-expert hidden dim
    first_dense_layers: int = 0        # leading layers that use a dense MLP
    router_aux_loss_coef: float = 0.001
    capacity_factor: float = 1.25

    # ---- block family ----
    block_type: str = "attn"           # attn | rwkv6 | mamba2
    ssm_state_dim: int = 0             # mamba2 N
    rwkv_head_dim: int = 64

    # ---- hybrid (zamba2): shared attention block every k mamba layers ----
    shared_attn_period: int = 0

    # ---- encoder-only / classification ----
    is_encoder: bool = False
    num_classes: int = 0               # >0 -> classification head on top

    # ---- modality frontend stub ----
    frontend: str = ""                 # "" | "audio" | "vision"

    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    tie_embeddings: bool = False

    # provenance (source paper / model card)
    citation: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def q_group_size(self) -> int:
        return self.num_heads // self.num_kv_heads

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def supports_decode(self) -> bool:
        return not self.is_encoder

    @property
    def subquadratic(self) -> bool:
        """True if a 500k-token decode context is tractable (per assignment)."""
        if self.block_type in ("rwkv6", "mamba2"):
            return True
        return self.sliding_window > 0

    @property
    def takes_embeddings(self) -> bool:
        """Modality-frontend archs consume precomputed embeddings (stub)."""
        return self.frontend != ""

    def reduced(self) -> "ModelConfig":
        """Smoke-test variant of the same family: <=2 layers, d_model<=512,
        <=4 experts — runs a real forward/train step on CPU."""
        d_model = min(self.d_model, 256)
        n_heads = min(self.num_heads, 4)
        n_kv = max(1, min(self.num_kv_heads, n_heads))
        # keep GQA grouping valid
        while n_heads % n_kv:
            n_kv -= 1
        changes = dict(
            name=self.name + "-smoke",
            num_layers=2,
            d_model=d_model,
            num_heads=n_heads,
            num_kv_heads=n_kv,
            head_dim=64 if self.head_dim else 0,
            d_ff=min(self.d_ff, 512),
            vocab_size=min(self.vocab_size, 512),
            dtype="float32",
        )
        if self.is_moe:
            changes.update(
                num_experts=4,
                num_experts_per_tok=min(2, self.num_experts_per_tok),
                num_shared_experts=min(1, self.num_shared_experts),
                moe_d_ff=128,
                first_dense_layers=min(1, self.first_dense_layers),
            )
        if self.use_mla:
            changes.update(kv_lora_rank=64, qk_nope_head_dim=32,
                           qk_rope_head_dim=16, v_head_dim=32)
        if self.sliding_window:
            changes.update(sliding_window=64)
        if self.shared_attn_period:
            changes.update(shared_attn_period=2)
        if self.num_classes:
            changes.update(num_classes=min(self.num_classes, 32))
        return dataclasses.replace(self, **changes)


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


TRAIN_4K = ShapeConfig("train_4k", 4_096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32_768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524_288, 1, "decode")

INPUT_SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}


def with_sliding_window(cfg: ModelConfig, window: int) -> ModelConfig:
    """Beyond-paper variant: retrofit sliding-window attention onto a dense
    arch so the long_500k decode shape becomes sub-quadratic/O(window)
    (DESIGN.md §4 extension). The KV cache becomes a `window`-slot ring
    buffer; all other dims unchanged."""
    assert not cfg.is_encoder and cfg.block_type == "attn"
    return dataclasses.replace(cfg, name=f"{cfg.name}-swa{window}",
                               sliding_window=window)


def shape_applicable(model: ModelConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """(applicable?, reason-if-not). Mirrors DESIGN.md's skip table."""
    if shape.kind == "decode":
        if not model.supports_decode:
            return False, "encoder-only architecture has no decode step"
        if shape.seq_len > 65_536 and not model.subquadratic:
            return False, "long_500k requires sub-quadratic attention"
    if model.is_encoder and shape.kind == "prefill":
        # encoders "prefill" == full forward; allowed.
        return True, ""
    return True, ""
