"""ctypes wrapper of the RWKV6 scan CUDA kernel (``csrc/rwkv6_scan.cu``).
The output ``y`` (and ``s_out``, unless the caller passes it) is
allocated here with ``torch.empty``; the kernel launches on PyTorch's
current stream and never synchronises."""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_SIZES = (16, 32, 64)

_P, _I = ctypes.c_void_p, ctypes.c_int


@functools.cache
def _lib() -> ctypes.CDLL:
    return build.bind("rwkv6_scan", {
        "rwkv6_scan": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                       _P],
    })


def rwkv6_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               w: torch.Tensor, u: torch.Tensor, s0: torch.Tensor,
               s_out: torch.Tensor | None = None):
    """r, k, v [B, T, H, M] (one dtype, f32 or bf16), w [B, T, H, M] f32,
    u [H, M] f32, s0 [B, H, M, M] f32, all CUDA and contiguous, M in
    HEAD_SIZES, T >= 1 -> (y [B, T, H, M] f32, s_T [B, H, M, M] f32).
    ``s_out`` (f32 [B, H, M, M], contiguous) receives s_T; it may be
    ``s0`` itself, which then holds the new state (the kernel reads every
    column of s0 before it writes that column)."""
    for name, t in (("r", r), ("k", k), ("v", v)):
        build.require_cuda(t, name, DTYPE_CODES, 4)
    build.require_cuda(w, "w", (torch.float32,), 4)
    build.require_cuda(u, "u", (torch.float32,), 2)
    build.require_cuda(s0, "s0", (torch.float32,), 4)
    b, t, h, m = r.shape
    if not r.dtype == k.dtype == v.dtype:
        raise TypeError("r, k and v must share a dtype")
    if (k.shape != r.shape or v.shape != r.shape or w.shape != r.shape
            or tuple(u.shape) != (h, m) or tuple(s0.shape) != (b, h, m, m)):
        raise ValueError(f"shapes r {tuple(r.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}, w {tuple(w.shape)}, u "
                         f"{tuple(u.shape)}, s0 {tuple(s0.shape)}")
    if m not in HEAD_SIZES:
        raise ValueError(f"head size {m} not in {HEAD_SIZES}")
    if t == 0 or b * h == 0:
        raise ValueError(f"need T >= 1 and B*H >= 1, got shape "
                         f"{tuple(r.shape)}")
    if s_out is None:
        s_out = torch.empty_like(s0)
    else:
        build.require_cuda(s_out, "s_out", (torch.float32,), 4)
        if s_out.shape != s0.shape:
            raise ValueError(f"s_out {tuple(s_out.shape)} != s0 "
                             f"{tuple(s0.shape)}")
    dev = r.device
    if any(z.device != dev for z in (k, v, w, u, s0, s_out)):
        raise ValueError("every input must be on one device")
    y = torch.empty((b, t, h, m), dtype=torch.float32, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        err = lib.rwkv6_scan(build.ptr(r), build.ptr(k), build.ptr(v),
                             build.ptr(w), build.ptr(u), build.ptr(s0),
                             build.ptr(y), build.ptr(s_out),
                             DTYPE_CODES[r.dtype], b, t, h, m,
                             build.stream_of(r))
    build.check(lib, err, "rwkv6_scan")
    return y, s_out
