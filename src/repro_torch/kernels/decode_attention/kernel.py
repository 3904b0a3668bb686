"""ctypes wrapper of the decode-attention CUDA kernel
(``csrc/decode_attention.cu``) and its launch plan. The output and the
split partials are allocated here with ``torch.empty``; the kernels
launch on PyTorch's current stream and never synchronise. The plan is
cached per shape, so the 992 calls of a generate run compute it once."""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from repro_torch.kernels import build

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (64, 80, 112, 128)
MAX_GROUP = 16          # query heads per KV head (the kernel's registers)
KEY_TILE = 32           # keys per staged tile; a split is a multiple
STAGES = 4              # tiles in the cp.async ring
THREADS = 128
WARPS = THREADS // 32
MIN_CHUNK = 2 * KEY_TILE        # fewest keys a split streams
SM_COUNT = 132                  # H100 SXM
SMEM_PER_SM = 233_472           # 228 KB of shared memory per SM
SMEM_PER_BLOCK = 232_448        # the most one block may use
SMEM_RESERVED = 1024            # the driver's share per resident block
# blocks of 128 threads an SM holds by registers, at <= 128 a thread
MAX_RESIDENT = 4

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


@functools.cache
def _lib() -> ctypes.CDLL:
    return build.bind("decode_attention", {
        "decode_attention": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                             _I, _I, _I, _F, _I, _P],
    })


def staged_head_dim(hd: int) -> int:
    """The row width the kernel stages a head dim at in shared memory:
    64 or 128 (hd 80 and 112 -> 128; the padding is never loaded)."""
    return -(-hd // 64) * 64


class DecodePlan(NamedTuple):
    """How ``decode_attention`` launches: ``nsplit`` x (B*K) blocks of
    THREADS, each streaming ``chunk`` keys (whole tiles) through a ring of
    ``stages`` tiles in ``smem_bytes`` of dynamic shared memory;
    ``group_pad`` query heads (G rounded up to a power of two); an SM
    holds ``resident`` blocks, which keep ``inflight_bytes`` of K and V in
    flight on it."""
    nsplit: int
    chunk: int
    group_pad: int
    stages: int
    smem_bytes: int
    resident: int
    inflight_bytes: int


@functools.cache
def splits(b: int, kh: int, s: int, g: int, hd: int,
           esz: int) -> DecodePlan:
    """The plan for caches [b, s, kh, hd] of ``esz``-byte elements and g
    query heads per KV head. Bytes, not blocks, set it: each block keeps
    STAGES - 1 tiles in flight, the shared memory decides how many blocks
    an SM holds, and the S axis is cut so that the B*K pairs fill one
    wave of them (more splits would leave a partial second wave). The
    rings hold rows at the staged width (hd 80, 112 -> 128: the hd-128
    figure). Raises once per plan if the shared memory exceeds what a
    block may use."""
    gp = 1 << max(0, g - 1).bit_length()
    tile = KEY_TILE * staged_head_dim(hd) * esz    # bytes of K (or V)
    # the K and V rings; the scores [max(gp, 8), tile + 1] in fp32 (bf16,
    # from the tensor cores) or q [gp, hd] in fp32 (f32); P per warp
    scores = max(gp, 8) * (KEY_TILE + 1) * 4 if esz == 2 else gp * hd * 4
    smem = 2 * STAGES * tile + scores + WARPS * max(1, gp // WARPS) \
        * KEY_TILE * 4
    if smem > SMEM_PER_BLOCK:
        raise ValueError(f"decode plan needs {smem} bytes of shared memory")
    resident = max(1, min(MAX_RESIDENT, SMEM_PER_SM // (smem + SMEM_RESERVED)))
    want = max(1, SM_COUNT * resident // (b * kh))
    chunk = -(-s // want)
    chunk = max(MIN_CHUNK, -(-chunk // KEY_TILE) * KEY_TILE)
    return DecodePlan(-(-s // chunk), chunk, gp, STAGES, smem, resident,
                      resident * (STAGES - 1) * 2 * tile)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor,
                     kv_len: torch.Tensor) -> torch.Tensor:
    """q [B, H, hd]; caches [B, S, K, hd] (one dtype, f32 or bf16, CUDA,
    contiguous; hd 64, 80, 112 or 128; H % K == 0, H/K <= 16); kv_len [B]
    int32 on the same device, each in [1, S] -> [B, H, hd] in q's
    dtype."""
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
    p = splits(b, kh, s, h // kh, hd, q.element_size())
    nsplit, chunk = p.nsplit, p.chunk
    dev = q.device
    o = torch.empty_like(q)
    # one scratch buffer: the splits' partial outputs, then their (m, l)
    n_o = b * h * nsplit * hd
    part = torch.empty(n_o + b * h * nsplit * 2, dtype=torch.float32,
                       device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        err = lib.decode_attention(
            build.ptr(q), build.ptr(k_cache), build.ptr(v_cache),
            build.ptr(kv_len), build.ptr(o), build.ptr(part),
            ctypes.c_void_p(part.data_ptr() + 4 * n_o),
            DTYPE_CODES[q.dtype], b, s, h, kh, hd, chunk,
            nsplit, 1.0 / math.sqrt(hd), p.smem_bytes, build.stream_of(q))
    build.check(lib, err, "decode_attention")
    return o
