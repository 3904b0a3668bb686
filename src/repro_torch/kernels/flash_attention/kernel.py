"""ctypes wrapper of the flash-attention prefill CUDA kernel
(``csrc/flash_attention.cu``) and its launch plan. The output is
allocated here with ``torch.empty``."""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from repro_torch.kernels import build

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (64, 80, 112, 128)
MAX_SMEM_PER_BLOCK = 232_448   # the most shared memory one H100 block may use
THREADS = 128

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


@functools.cache
def _lib() -> ctypes.CDLL:
    return build.bind("flash_attention", {
        "flash_prefill": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                          _F, _I, _P],
    })


class FlashPlan(NamedTuple):
    """How ``flash_prefill`` launches: ``grid`` (row tiles, B*K) of
    ``threads``; each block owns ``rows`` fused (t, g) rows and streams
    K/V in tiles of ``keys``, ``stages`` tiles deep, in ``smem_bytes`` of
    shared memory (dynamic for the bf16 wgmma kernel, ``tensor_cores``;
    static for the f32 one)."""
    grid: tuple[int, int]
    threads: int
    rows: int
    keys: int
    stages: int
    smem_bytes: int
    tensor_cores: bool


def staged_head_dim(hd: int) -> int:
    """The width the bf16 kernel stages a head dim at, in shared memory:
    whole 64-column swizzle atoms (hd 80 and 112 -> 128, the columns past hd
    zero-filled)."""
    return -(-hd // 64) * 64


@functools.cache
def plan(b: int, t: int, kh: int, g: int, hd: int,
         dtype: torch.dtype) -> FlashPlan:
    """The launch plan for q [b, t, kh*g, hd] in ``dtype``: bf16 on the
    tensor cores (one warpgroup's 64 rows, 64-key tiles, a 2-stage
    cp.async ring of bf16 K/V with Q, at the staged width, in dynamic
    shared memory aligned to 1 KB); f32 on the CUDA cores (16 rows, 32-key
    tiles of fp32 in static shared memory). Raises if the shared memory
    exceeds what a block may use."""
    if dtype == torch.bfloat16:
        rows, keys, stages = 64, 64, 2
        smem = (rows + 2 * stages * keys) * staged_head_dim(hd) * 2 \
            + 1024  # + alignment
    else:
        rows, keys, stages = 16, 32, 1
        smem = (rows * (hd + 1) + 2 * keys * (hd + 1) + rows * (keys + 1)) * 4
    if smem > MAX_SMEM_PER_BLOCK:
        raise ValueError(f"flash plan needs {smem} bytes of shared memory")
    return FlashPlan((-(-t * g // rows), b * kh), THREADS, rows, keys, stages,
                     smem, dtype == torch.bfloat16)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q: [B, T, H, hd]; k, v: [B, S, K, hd] (one dtype, f32 or bf16,
    CUDA, contiguous, bf16 16-byte aligned; hd 64, 80, 112 or 128;
    H % K == 0) ->
    [B, T, H, hd]."""
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
    if q.dtype == torch.bfloat16 and any(x.data_ptr() % 16
                                         for x in (q, k, v)):
        raise ValueError("bf16 q, k and v must be 16-byte aligned")
    p = plan(b, t, kh, h // kh, hd, q.dtype)
    o = torch.empty_like(q)
    lib = _lib()
    with torch.cuda.device(q.device):
        err = lib.flash_prefill(
            build.ptr(q), build.ptr(k), build.ptr(v), build.ptr(o),
            DTYPE_CODES[q.dtype], b, t, s, h, kh, hd, int(causal),
            int(window), 1.0 / math.sqrt(hd), p.smem_bytes,
            build.stream_of(q))
    build.check(lib, err, "flash_prefill")
    return o
