"""HuBERT X-Large [arXiv:2106.07447] — encoder-only audio backbone (same
arch as wav2vec2). The conv/mel frontend is a stub: input_specs provides
precomputed frame embeddings. vocab 504 = frame-classification targets."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge",
    family="audio",
    num_layers=48,
    d_model=1280,
    num_heads=16,
    num_kv_heads=16,
    d_ff=5120,
    vocab_size=504,
    is_encoder=True,
    num_classes=504,
    frontend="audio",
    citation="arXiv:2106.07447",
)
