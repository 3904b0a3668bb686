"""ctypes wrapper of the MDSA Mahalanobis-distance CUDA kernel
(``csrc/mdsa.cu``). The output and the per-tile partials are allocated
here with ``torch.empty``; the kernels launch on PyTorch's current stream
and never synchronise."""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

COL_TILE = 64                   # columns j per block (the partials' rows)
ROW_TILE = 64                   # batch rows per block
MAX_ROW_TILES = 65535           # the grid's y limit

_P, _I = ctypes.c_void_p, ctypes.c_int


@functools.cache
def _lib() -> ctypes.CDLL:
    return build.bind("mdsa", {"mdsa": [_P, _P, _P, _P, _P, _I, _I, _P]})


def mdsa(x: torch.Tensor, mean: torch.Tensor,
         prec: torch.Tensor) -> torch.Tensor:
    """x [B, D], mean [D], prec [D, D] (f32, CUDA, contiguous; any
    B, D >= 1) -> sqrt(max((x - mean)^T prec (x - mean), 0)) [B] f32."""
    build.require_cuda(x, "x", (torch.float32,), 2)
    build.require_cuda(mean, "mean", (torch.float32,), 1)
    build.require_cuda(prec, "prec", (torch.float32,), 2)
    b, d = x.shape
    if tuple(mean.shape) != (d,) or tuple(prec.shape) != (d, d):
        raise ValueError(f"shapes x {tuple(x.shape)}, mean "
                         f"{tuple(mean.shape)}, prec {tuple(prec.shape)}")
    if b == 0 or d == 0 or -(-b // ROW_TILE) > MAX_ROW_TILES:
        raise ValueError(f"x {tuple(x.shape)}: need B, D >= 1 and B <= "
                         f"{ROW_TILE * MAX_ROW_TILES}")
    dev = x.device
    if mean.device != dev or prec.device != dev:
        raise ValueError("x, mean and prec must share a device")
    part = torch.empty(-(-d // COL_TILE) * b, dtype=torch.float32,
                       device=dev)
    out = torch.empty(b, dtype=torch.float32, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        err = lib.mdsa(build.ptr(x), build.ptr(mean), build.ptr(prec),
                       build.ptr(part), build.ptr(out), b, d,
                       build.stream_of(x))
    build.check(lib, err, "mdsa")
    return out
