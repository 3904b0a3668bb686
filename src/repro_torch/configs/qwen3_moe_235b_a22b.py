"""Qwen3-MoE-235B-A22B [hf:Qwen/Qwen3-30B-A3B family] — 94L, 128 routed
experts top-8, GQA kv=4, head_dim 128."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    num_layers=94,
    d_model=4096,
    num_heads=64,
    num_kv_heads=4,
    head_dim=128,
    d_ff=1536,           # unused for MoE layers (moe_d_ff); kept for parity
    vocab_size=151936,
    rope_theta=1_000_000.0,
    num_experts=128,
    num_experts_per_tok=8,
    moe_d_ff=1536,
    citation="hf:Qwen/Qwen3-30B-A3B",
)
