"""Public wrapper of the flash-attention prefill: a CPU tensor goes to the
plain version (``ref.py``), a CUDA tensor launches the CUDA kernel or
raises, a fake tensor (the dry-run) goes to the kernel's op
``repro_torch::flash_attention``, which launches nothing and is counted
as the kernel. ``LAUNCHES`` counts the kernel launches."""

from __future__ import annotations

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels.build import count_launch, is_fake, refuse_grad
from repro_torch.kernels.flash_attention import kernel
from repro_torch.kernels.flash_attention.ref import attention_ref

LAUNCHES = {"flash_attention": 0}


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=(),
                         device_types="cuda")
def flash_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       causal: bool, window: int) -> torch.Tensor:
    """The kernel as an op: its CUDA implementation is the launch."""
    return kernel.flash_attention(q, k, v, causal=causal, window=window)


@flash_attention_op.register_fake
def _(q, k, v, causal, window):
    return torch.empty_like(q, memory_format=torch.contiguous_format)


@register_flop_formula(torch.ops.repro_torch.flash_attention)
def _flops(q_shape, k_shape, v_shape, causal, window, *, out_shape=None,
           **kwargs) -> int:
    """The plain version's count: QK^T and PV over every key, masked
    ones too (2 x 2 B T H S hd)."""
    b, t, h, hd = q_shape
    return 4 * b * t * h * k_shape[1] * hd


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int = 0) -> torch.Tensor:
    """q: [B, T, H, hd]; k, v: [B, S, K, hd] -> [B, T, H, hd]."""
    if is_fake(q):
        refuse_grad("flash_attention", q, k, v)
        return flash_attention_op(q, k, v, causal, window)
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window)
    refuse_grad("flash_attention", q, k, v)
    out = kernel.flash_attention(q, k, v, causal=causal, window=window)
    count_launch(LAUNCHES, "flash_attention")
    return out
