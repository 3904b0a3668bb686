"""Modality frontend stubs, in PyTorch (``repro.models.frontend``).

The audio (hubert-xlarge) and vision-language (pixtral-12b) architectures
specify the transformer backbone only; the mel-spectrogram and conv
feature extractor and the ViT encoder and projector are not implemented.
``frontend_embeddings`` gives the embedding tensor such a frontend would
emit: the shape, dtype and deterministic content the backbone takes.

JAX draws them from ``jax.random.PRNGKey(seed)``; the port from a CPU
``torch.Generator`` seeded by ``seed`` (the same values on every device).
The two cannot give the same bits, so the parity tests feed both packages
the same numpy embeddings.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.transformer import DTYPES


def frontend_embeddings(cfg: ModelConfig, batch: int, seq_len: int,
                        seed: int = 0, device: str | torch.device = "cuda"
                        ) -> torch.Tensor:
    """Deterministic stand-in for frame (audio) or patch (vision)
    embeddings: standard normal [batch, seq_len, d_model] in the config's
    dtype, on ``device``."""
    if not cfg.takes_embeddings:
        raise ValueError(f"{cfg.name} takes no frontend embeddings")
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn((batch, seq_len, cfg.d_model), generator=gen)
    return x.to(DTYPES[cfg.dtype]).to(dev)
