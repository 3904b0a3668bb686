"""RWKV6 "Finch" 1.6B [arXiv:2404.05892] — attention-free, data-dependent
decay linear attention. O(1) state -> native long_500k."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b",
    family="ssm",
    num_layers=24,
    d_model=2048,
    num_heads=32,          # d_model / rwkv_head_dim
    num_kv_heads=32,
    d_ff=7168,
    vocab_size=65536,
    block_type="rwkv6",
    rwkv_head_dim=64,
    citation="arXiv:2404.05892",
)
