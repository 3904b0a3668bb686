"""Public wrapper of single-token decode attention: a CPU tensor goes to
the plain version (``ref.py``), a CUDA tensor launches the CUDA kernel or
raises. ``LAUNCHES`` counts the kernel launches, one per wrapper call.

Contract: every ``kv_len[b] >= 1`` (the decode path passes ``pos + 1``).
At 0 the kernel writes 0, as the Pallas kernel does, while the plain
version writes the mean of V (a uniform softmax over the masked slots).
"""

from __future__ import annotations

import torch

from repro_torch.kernels.build import count_launch, refuse_grad
from repro_torch.kernels.decode_attention import kernel
from repro_torch.kernels.decode_attention.ref import decode_attention_ref

LAUNCHES = {"decode_attention": 0}


def decode_attn(q: torch.Tensor, k_cache: torch.Tensor,
                v_cache: torch.Tensor, kv_len: torch.Tensor) -> torch.Tensor:
    """q: [B, H, hd]; caches: [B, S, K, hd]; kv_len: [B] int32 ->
    [B, H, hd]."""
    if q.device.type == "cpu":
        return decode_attention_ref(q, k_cache, v_cache, kv_len)
    refuse_grad("decode_attention", q, k_cache, v_cache)
    out = kernel.decode_attention(q, k_cache, v_cache, kv_len)
    count_launch(LAUNCHES, "decode_attention")
    return out
