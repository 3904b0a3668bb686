"""Public wrapper of single-token decode attention: a CPU tensor goes to
the plain version (``ref.py``), a CUDA tensor launches the CUDA kernel or
raises, a fake tensor (the dry-run) goes to the kernel's op
``repro_torch::decode_attention``, which launches nothing and is counted
as the kernel, its scratch held while it runs. ``LAUNCHES`` counts the
kernel launches, one per wrapper call.

Contract: every ``kv_len[b] >= 1`` (the decode path passes ``pos + 1``).
At 0 the kernel writes 0, as the Pallas kernel does, while the plain
version writes the mean of V (a uniform softmax over the masked slots).
"""

from __future__ import annotations

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels.build import (SCRATCH_BYTES, count_launch, is_fake,
                                       refuse_grad)
from repro_torch.kernels.decode_attention import kernel
from repro_torch.kernels.decode_attention.ref import decode_attention_ref

LAUNCHES = {"decode_attention": 0}


@torch.library.custom_op("repro_torch::decode_attention", mutates_args=(),
                         device_types="cuda")
def decode_attention_op(q: torch.Tensor, k_cache: torch.Tensor,
                        v_cache: torch.Tensor,
                        kv_len: torch.Tensor) -> torch.Tensor:
    """The kernel as an op: its CUDA implementation is the launch."""
    return kernel.decode_attention(q, k_cache, v_cache, kv_len)


@decode_attention_op.register_fake
def _(q, k_cache, v_cache, kv_len):
    return torch.empty_like(q, memory_format=torch.contiguous_format)


@register_flop_formula(torch.ops.repro_torch.decode_attention)
def _flops(q_shape, k_shape, v_shape, len_shape, *, out_shape=None,
           **kwargs) -> int:
    """The plain version's count: QK^T and PV over every slot of the
    cache (2 x 2 B H S hd)."""
    b, h, hd = q_shape
    return 4 * b * h * k_shape[1] * hd


def _scratch_bytes(q, k_cache, v_cache, kv_len) -> int:
    """The launch's fp32 scratch, by its plan."""
    b, h, hd = q.shape
    s, kh = k_cache.shape[1], k_cache.shape[2]
    p = kernel.splits(b, kh, s, h // kh, hd, q.element_size())
    return 4 * kernel.scratch_numel(b, h, hd, p.nsplit)


SCRATCH_BYTES[torch.ops.repro_torch.decode_attention] = _scratch_bytes


def decode_attn(q: torch.Tensor, k_cache: torch.Tensor,
                v_cache: torch.Tensor, kv_len: torch.Tensor) -> torch.Tensor:
    """q: [B, H, hd]; caches: [B, S, K, hd]; kv_len: [B] int32 ->
    [B, H, hd]."""
    if is_fake(q):
        refuse_grad("decode_attention", q, k_cache, v_cache)
        return decode_attention_op(q, k_cache, v_cache, kv_len)
    if q.device.type == "cpu":
        return decode_attention_ref(q, k_cache, v_cache, kv_len)
    refuse_grad("decode_attention", q, k_cache, v_cache)
    out = kernel.decode_attention(q, k_cache, v_cache, kv_len)
    count_launch(LAUNCHES, "decode_attention")
    return out
