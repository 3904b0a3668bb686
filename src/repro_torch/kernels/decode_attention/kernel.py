"""ctypes wrapper of the decode-attention CUDA kernel
(``csrc/decode_attention.cu``). The output and the split partials are
allocated here with ``torch.empty``; the kernels launch on PyTorch's
current stream and never synchronise."""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import build

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (64, 128)
MAX_GROUP = 16          # query heads per KV head (the kernel's registers)
KEY_TILE = 32           # keys per staged tile; a split is a multiple
MIN_CHUNK = 64          # fewest keys a split streams
TARGET_BLOCKS = 264     # two blocks per SM of the H100's 132

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


@functools.cache
def _lib() -> ctypes.CDLL:
    return build.bind("decode_attention", {
        "decode_attention": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                             _I, _I, _I, _F, _P],
    })


def splits(b: int, kh: int, s: int) -> tuple[int, int]:
    """(nsplit, chunk): the cache's S axis cut into nsplit chunks of
    ``chunk`` keys (a multiple of the tile), enough that the B*K pairs
    give about TARGET_BLOCKS blocks."""
    want = max(1, -(-TARGET_BLOCKS // (b * kh)))
    chunk = -(-s // want)
    chunk = max(MIN_CHUNK, -(-chunk // KEY_TILE) * KEY_TILE)
    return -(-s // chunk), chunk


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor,
                     kv_len: torch.Tensor) -> torch.Tensor:
    """q [B, H, hd]; caches [B, S, K, hd] (one dtype, f32 or bf16, CUDA,
    contiguous; hd 64 or 128; H % K == 0, H/K <= 16); kv_len [B] int32 on
    the same device, each in [1, S] -> [B, H, hd] in q's dtype."""
    build.require_cuda(q, "q", DTYPE_CODES, 3)
    build.require_cuda(k_cache, "k_cache", DTYPE_CODES, 4)
    build.require_cuda(v_cache, "v_cache", DTYPE_CODES, 4)
    build.require_cuda(kv_len, "kv_len", (torch.int32,), 1)
    b, h, hd = q.shape
    s, kh = k_cache.shape[1], k_cache.shape[2]
    if (k_cache.shape != v_cache.shape or k_cache.shape[0] != b
            or k_cache.shape[3] != hd or kv_len.shape[0] != b or s == 0
            or h % kh):
        raise ValueError(f"shapes q {tuple(q.shape)}, k_cache "
                         f"{tuple(k_cache.shape)}, v_cache "
                         f"{tuple(v_cache.shape)}, kv_len "
                         f"{tuple(kv_len.shape)}")
    if not q.dtype == k_cache.dtype == v_cache.dtype:
        raise TypeError("q, k_cache and v_cache must share a dtype")
    if not q.device == k_cache.device == v_cache.device == kv_len.device:
        raise ValueError("q, caches and kv_len must share a device")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} not in {HEAD_DIMS}")
    if h // kh > MAX_GROUP:
        raise ValueError(f"{h // kh} query heads per KV head > {MAX_GROUP}")
    if any(t.data_ptr() % 16 for t in (q, k_cache, v_cache)):
        raise ValueError("q and the caches must be 16-byte aligned")
    if b * kh > 65535:
        raise ValueError(f"B*K = {b * kh} exceeds the grid's y limit")
    nsplit, chunk = splits(b, kh, s)
    dev = q.device
    o = torch.empty_like(q)
    # one scratch buffer: the splits' partial outputs, then their (m, l)
    n_o = b * h * nsplit * hd
    part = torch.empty(n_o + b * h * nsplit * 2, dtype=torch.float32,
                       device=dev)
    part_o, part_ml = part[:n_o], part[n_o:]
    lib = _lib()
    with torch.cuda.device(dev):
        err = lib.decode_attention(
            build.ptr(q), build.ptr(k_cache), build.ptr(v_cache),
            build.ptr(kv_len), build.ptr(o), build.ptr(part_o),
            build.ptr(part_ml), DTYPE_CODES[q.dtype], b, s, h, kh, hd, chunk,
            nsplit, 1.0 / math.sqrt(hd), build.stream_of(q))
    build.check(lib, err, "decode_attention")
    return o
