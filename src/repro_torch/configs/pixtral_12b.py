"""Pixtral-12B [hf:mistralai/Pixtral-12B-2409] — mistral-nemo decoder
backbone; the Pixtral-ViT vision encoder + projector is a stub
(input_specs provides patch embeddings)."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="pixtral-12b",
    family="vlm",
    num_layers=40,
    d_model=5120,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=131072,
    rope_theta=1_000_000.0,
    frontend="vision",
    citation="hf:mistralai/Pixtral-12B-2409",
)
