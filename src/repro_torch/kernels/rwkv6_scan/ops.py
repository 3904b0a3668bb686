"""Public wrapper of the RWKV6 time-mix recurrence: a CPU tensor goes to
the plain version (``ref.py``), a CUDA tensor launches the CUDA kernel or
raises, a fake tensor (the dry-run) goes to the kernel's op
``repro_torch::rwkv6_scan``, which launches nothing and is counted as the
kernel over all T steps. ``LAUNCHES`` counts the kernel launches, one
per wrapper call.

``s_out`` lets the caller update a recurrent state in place: pass the
layer's state slice as both ``s0`` and ``s_out`` and it holds s_T after
the call, on either device."""

from __future__ import annotations

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels.build import count_launch, is_fake, refuse_grad
from repro_torch.kernels.rwkv6_scan import kernel
from repro_torch.kernels.rwkv6_scan.ref import rwkv6_scan_ref

LAUNCHES = {"rwkv6_scan": 0}


@torch.library.custom_op("repro_torch::rwkv6_scan", mutates_args=("s_out",),
                         device_types="cuda")
def rwkv6_scan_op(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  w: torch.Tensor, u: torch.Tensor, s0: torch.Tensor,
                  s_out: torch.Tensor) -> torch.Tensor:
    """The kernel as an op: its CUDA implementation is the launch, y
    returned and s_T written into ``s_out`` (which may be ``s0``)."""
    return kernel.rwkv6_scan(r, k, v, w, u, s0, s_out)[0]


@rwkv6_scan_op.register_fake
def _(r, k, v, w, u, s0, s_out):
    return r.new_empty(r.shape, dtype=torch.float32)


@register_flop_formula(torch.ops.repro_torch.rwkv6_scan)
def _flops(r_shape, *shapes, out_shape=None, **kwargs) -> int:
    """The plain version's count: r_t S_t, a [1, M] x [M, M] product a
    head and step (2 B T H M^2)."""
    b, t, h, m = r_shape
    return 2 * b * t * h * m * m


def rwkv6_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               w: torch.Tensor, u: torch.Tensor, s0: torch.Tensor,
               s_out: torch.Tensor | None = None):
    """r, k, v, w: [B, T, H, M]; u: [H, M]; s0: [B, H, M, M] f32 ->
    (y [B, T, H, M] f32, s_T [B, H, M, M] f32); s_T is ``s_out`` when
    given."""
    if is_fake(r):
        refuse_grad("rwkv6_scan", r, k, v, w, u, s0)
        s_t = torch.empty_like(s0) if s_out is None else s_out
        return rwkv6_scan_op(r, k, v, w, u, s0, s_t), s_t
    if r.device.type == "cpu":
        y, s_t = rwkv6_scan_ref(r, k, v, w, u, s0)
        if s_out is None:
            return y, s_t
        return y, s_out.copy_(s_t)
    refuse_grad("rwkv6_scan", r, k, v, w, u, s0)
    out = kernel.rwkv6_scan(r, k, v, w, u, s0, s_out)
    count_launch(LAUNCHES, "rwkv6_scan")
    return out
