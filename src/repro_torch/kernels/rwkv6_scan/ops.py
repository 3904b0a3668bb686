"""Public wrapper of the RWKV6 time-mix recurrence: a CPU tensor goes to
the plain version (``ref.py``), a CUDA tensor launches the CUDA kernel or
raises. ``LAUNCHES`` counts the kernel launches, one per wrapper call.

``s_out`` lets the caller update a recurrent state in place: pass the
layer's state slice as both ``s0`` and ``s_out`` and it holds s_T after
the call, on either device."""

from __future__ import annotations

import torch

from repro_torch.kernels.build import count_launch, refuse_grad
from repro_torch.kernels.rwkv6_scan import kernel
from repro_torch.kernels.rwkv6_scan.ref import rwkv6_scan_ref

LAUNCHES = {"rwkv6_scan": 0}


def rwkv6_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               w: torch.Tensor, u: torch.Tensor, s0: torch.Tensor,
               s_out: torch.Tensor | None = None):
    """r, k, v, w: [B, T, H, M]; u: [H, M]; s0: [B, H, M, M] f32 ->
    (y [B, T, H, M] f32, s_T [B, H, M, M] f32); s_T is ``s_out`` when
    given."""
    if r.device.type == "cpu":
        y, s_t = rwkv6_scan_ref(r, k, v, w, u, s0)
        if s_out is None:
            return y, s_t
        return y, s_out.copy_(s_t)
    refuse_grad("rwkv6_scan", r, k, v, w, u, s0)
    out = kernel.rwkv6_scan(r, k, v, w, u, s0, s_out)
    count_launch(LAUNCHES, "rwkv6_scan")
    return out
