"""H2O-Danube-1.8B [arXiv:2401.16818] — llama+mistral mix with sliding-
window attention (window 4096) -> sub-quadratic, runs long_500k."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-1.8b",
    family="dense",
    num_layers=24,
    d_model=2560,
    num_heads=32,
    num_kv_heads=8,
    d_ff=6912,
    vocab_size=32000,
    sliding_window=4096,
    citation="arXiv:2401.16818",
)
