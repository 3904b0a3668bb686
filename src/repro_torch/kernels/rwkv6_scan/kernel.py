"""ctypes wrapper of the RWKV6 scan CUDA kernel (``csrc/rwkv6_scan.cu``).
The output ``y`` (and ``s_out``, unless the caller passes it) is
allocated here with ``torch.empty``; the kernel launches on PyTorch's
current stream and never synchronises. The shape checks and launch
arguments are a plan cached per shape, so the 744 decode steps of a
generate run compute them once."""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import build

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_SIZES = (16, 32, 64)
CHUNK = 32              # tokens per chunk of the kernel's copy ring
ROW_GROUPS = 8          # the kernel cuts a head's state into 8 x 8 tiles

_P, _I = ctypes.c_void_p, ctypes.c_int


@functools.cache
def _lib() -> ctypes.CDLL:
    return build.bind("rwkv6_scan", {
        "rwkv6_scan": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                       _P],
    })


class ScanPlan(NamedTuple):
    """How ``rwkv6_scan`` launches for r [b, t, h, m] of ``dtype``: the
    shapes the other inputs must have and the integer arguments of the C
    entry point."""
    u_shape: tuple
    s_shape: tuple
    args: tuple


@functools.cache
def plan(b: int, t: int, h: int, m: int, dtype: torch.dtype) -> ScanPlan:
    """The plan for r [b, t, h, m] of ``dtype`` (raises, uncached, on a
    head size or length the kernel does not take)."""
    if m not in HEAD_SIZES:
        raise ValueError(f"head size {m} not in {HEAD_SIZES}")
    if t == 0 or b * h == 0:
        raise ValueError(f"need T >= 1 and B*H >= 1, got shape "
                         f"{(b, t, h, m)}")
    return ScanPlan((h, m), (b, h, m, m), (DTYPE_CODES[dtype], b, t, h, m))


def rwkv6_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               w: torch.Tensor, u: torch.Tensor, s0: torch.Tensor,
               s_out: torch.Tensor | None = None):
    """r, k, v [B, T, H, M] (one dtype, f32 or bf16), w [B, T, H, M] f32,
    u [H, M] f32, s0 [B, H, M, M] f32, all CUDA, contiguous and (but u)
    16-byte aligned, M in HEAD_SIZES, T >= 1 -> (y [B, T, H, M]
    f32, s_T [B, H, M, M] f32). ``s_out`` (f32 [B, H, M, M], contiguous)
    receives s_T; it may be ``s0`` itself, which then holds the new state
    (the kernel reads every part of s0 before it writes that part)."""
    for name, z in (("r", r), ("k", k), ("v", v)):
        build.require_cuda(z, name, DTYPE_CODES, 4)
    build.require_cuda(w, "w", (torch.float32,), 4)
    build.require_cuda(u, "u", (torch.float32,), 2)
    build.require_cuda(s0, "s0", (torch.float32,), 4)
    shape = r.shape
    if not r.dtype == k.dtype == v.dtype:
        raise TypeError("r, k and v must share a dtype")
    p = plan(*shape, r.dtype)
    if (k.shape != shape or v.shape != shape or w.shape != shape
            or u.shape != p.u_shape or s0.shape != p.s_shape):
        raise ValueError(f"shapes r {tuple(r.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}, w {tuple(w.shape)}, u "
                         f"{tuple(u.shape)}, s0 {tuple(s0.shape)}")
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
    ptrs = (r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u.data_ptr(), s0.data_ptr())
    s_ptr = s_out.data_ptr()
    if any(a % 16 for a in (*ptrs[:4], ptrs[5], s_ptr)):
        raise ValueError("r, k, v, w, s0 and s_out must be 16-byte aligned")
    y = torch.empty(shape, dtype=torch.float32, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        err = lib.rwkv6_scan(*ptrs, y.data_ptr(), s_ptr, *p.args,
                             build.stream_of(r))
    build.check(lib, err, "rwkv6_scan")
    return y, s_out
