"""DeepSeek-V2-Lite 16B [arXiv:2405.04434] — MoE with Multi-head Latent
Attention (kv_lora_rank=512), 2 shared + 64 routed experts, top-6, first
layer dense (the assignment line also mentions "160 routed", which is full
V2 — see DESIGN.md config-discrepancy note)."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    num_layers=27,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=10944,          # dense-layer FFN (layer 0)
    vocab_size=102400,
    use_mla=True,
    kv_lora_rank=512,
    qk_nope_head_dim=128,
    qk_rope_head_dim=64,
    v_head_dim=128,
    num_experts=64,
    num_experts_per_tok=6,
    num_shared_experts=2,
    moe_d_ff=1408,
    first_dense_layers=1,
    citation="arXiv:2405.04434",
)
