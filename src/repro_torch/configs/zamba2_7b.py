"""Zamba2-7B [arXiv:2411.15242] — Mamba2 backbone + shared attention
blocks. 81 mamba2 layers; one weight-shared attention+MLP block applied
every 9 layers (real model: ~every 6; 9 divides 81 and keeps the group
scan uniform — see DESIGN.md deviations). ssm_state=64."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    num_layers=81,
    d_model=3584,
    num_heads=32,
    num_kv_heads=32,       # shared block is MHA
    d_ff=14336,
    vocab_size=32000,
    block_type="mamba2",
    ssm_state_dim=64,
    shared_attn_period=9,
    citation="arXiv:2411.15242",
)
