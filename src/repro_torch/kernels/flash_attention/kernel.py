"""ctypes wrapper of the flash-attention prefill CUDA kernel
(``csrc/flash_attention.cu``). The output is allocated here with
``torch.empty``."""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import build

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (64, 128)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


@functools.cache
def _lib() -> ctypes.CDLL:
    return build.bind("flash_attention", {
        "flash_prefill": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                          _F, _P],
    })


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q: [B, T, H, hd]; k, v: [B, S, K, hd] (one dtype, f32 or bf16,
    CUDA, contiguous; hd 64 or 128; H % K == 0) -> [B, T, H, hd]."""
    for name, x in (("q", q), ("k", k), ("v", v)):
        build.require_cuda(x, name, DTYPE_CODES, 4)
    b, t, h, hd = q.shape
    s, kh = k.shape[1], k.shape[2]
    if (k.shape != v.shape or k.shape[0] != b or k.shape[3] != hd
            or h % kh or t == 0 or s == 0):
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    if not q.dtype == k.dtype == v.dtype:
        raise TypeError("q, k and v must share a dtype")
    if not q.device == k.device == v.device:
        raise ValueError("q, k and v must share a device")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} not in {HEAD_DIMS}")
    if b * kh > 65535:
        raise ValueError(f"B*K = {b * kh} exceeds the grid's y limit")
    o = torch.empty_like(q)
    lib = _lib()
    with torch.cuda.device(q.device):
        err = lib.flash_prefill(
            build.ptr(q), build.ptr(k), build.ptr(v), build.ptr(o),
            DTYPE_CODES[q.dtype], b, t, s, h, kh, hd, int(causal),
            int(window), 1.0 / math.sqrt(hd), build.stream_of(q))
    build.check(lib, err, "flash_prefill")
    return o
