"""ctypes wrapper of the fused head -> gate CUDA kernel
(``csrc/fused_head_gate.cu``): logits tiles live only in shared memory;
the kernel returns conf and pred, and the gate's select kernel ranks the
rows. Outputs and scratch are allocated here with ``torch.empty``."""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.confidence_gate.kernel import (DTYPE_CODES,
                                                        STATS_INT32S,
                                                        supervisor_code)

_P, _I = ctypes.c_void_p, ctypes.c_int


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.bind("fused_head_gate", {
        "fused_head_gate": [_P, _I, _P, _I, _P, _I, _I, _I, _I, _I, _P, _P,
                            _P, _P],
    })
    lib.fused_head_gate_tile_cols.argtypes = []
    lib.fused_head_gate_tile_cols.restype = ctypes.c_int
    return lib


def fused_head_gate(hidden: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                    supervisor: str):
    """hidden [B, D], w [D, C] (f32/bf16, CUDA, contiguous), bias [C] f32
    -> conf [B] f32, pred [B] i32."""
    build.require_cuda(hidden, "hidden", DTYPE_CODES, 2)
    build.require_cuda(w, "w", DTYPE_CODES, 2)
    build.require_cuda(bias, "bias", (torch.float32,), 1)
    b, d = hidden.shape
    dw, c = w.shape
    if d != dw or bias.shape[0] != c or b == 0 or c == 0:
        raise ValueError(f"shapes hidden {tuple(hidden.shape)}, w "
                         f"{tuple(w.shape)}, bias {tuple(bias.shape)}")
    if not hidden.device == w.device == bias.device:
        raise ValueError("hidden, w and bias must share a device")
    sup = supervisor_code(supervisor)
    lib = _lib()
    nsplit = -(-c // lib.fused_head_gate_tile_cols())
    dev = hidden.device
    part = torch.empty(b * nsplit * STATS_INT32S, dtype=torch.int32,
                       device=dev)
    conf = torch.empty(b, dtype=torch.float32, device=dev)
    pred = torch.empty(b, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = lib.fused_head_gate(
            build.ptr(hidden), DTYPE_CODES[hidden.dtype], build.ptr(w),
            DTYPE_CODES[w.dtype], build.ptr(bias), b, d, c, nsplit, sup,
            build.ptr(part), build.ptr(conf), build.ptr(pred),
            build.stream_of(hidden))
    build.check(lib, err, "fused_head_gate")
    return conf, pred
