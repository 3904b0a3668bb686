"""Public wrapper of the flash-attention prefill: a CPU tensor goes to the
plain version (``ref.py``), a CUDA tensor launches the CUDA kernel or
raises. ``LAUNCHES`` counts the kernel launches."""

from __future__ import annotations

import torch

from repro_torch.kernels.build import count_launch, refuse_grad
from repro_torch.kernels.flash_attention import kernel
from repro_torch.kernels.flash_attention.ref import attention_ref

LAUNCHES = {"flash_attention": 0}


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int = 0) -> torch.Tensor:
    """q: [B, T, H, hd]; k, v: [B, S, K, hd] -> [B, T, H, hd]."""
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window)
    refuse_grad("flash_attention", q, k, v)
    out = kernel.flash_attention(q, k, v, causal=causal, window=window)
    count_launch(LAUNCHES, "flash_attention")
    return out
