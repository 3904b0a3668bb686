"""ctypes wrapper of the fused supervisor-confidence CUDA kernel
(``csrc/maxconf.cu``). Outputs and scratch are allocated here with
``torch.empty``; the kernel launches on PyTorch's current stream and never
synchronises."""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.confidence_gate.kernel import (DTYPE_CODES,
                                                        STATS_INT32S,
                                                        score_splits)

MAX_ROWS = 65535                # the grid's y limit

_P, _I = ctypes.c_void_p, ctypes.c_int


@functools.cache
def _lib() -> ctypes.CDLL:
    return build.bind("maxconf", {
        "maxconf": [_P, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P],
    })


def maxconf(logits: torch.Tensor) -> dict[str, torch.Tensor]:
    """logits [B, V] f32/bf16 (CUDA, contiguous) -> {prediction [B] i32,
    max_softmax, pcs, entropy [B] f32}."""
    build.require_cuda(logits, "logits", DTYPE_CODES, 2)
    b, v = logits.shape
    if b == 0 or v == 0 or b > MAX_ROWS:
        raise ValueError(f"logits {tuple(logits.shape)}: need "
                         f"1 <= B <= {MAX_ROWS} and V >= 1")
    nsplit = score_splits(v)
    dev = logits.device
    part = torch.empty(b * nsplit * STATS_INT32S, dtype=torch.int32,
                       device=dev)
    pred = torch.empty(b, dtype=torch.int32, device=dev)
    ms, pcs, ent = (torch.empty(b, dtype=torch.float32, device=dev)
                    for _ in range(3))
    lib = _lib()
    with torch.cuda.device(dev):
        err = lib.maxconf(build.ptr(logits), DTYPE_CODES[logits.dtype], b, v,
                          nsplit, build.ptr(part), build.ptr(pred),
                          build.ptr(ms), build.ptr(pcs), build.ptr(ent),
                          build.stream_of(logits))
    build.check(lib, err, "maxconf")
    return {"prediction": pred, "max_softmax": ms, "pcs": pcs,
            "entropy": ent}
