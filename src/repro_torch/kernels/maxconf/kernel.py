"""ctypes wrapper of the fused supervisor-confidence CUDA kernel
(``csrc/maxconf.cu``, the statistics pass of ``csrc/vocab_stats.cuh``).
The outputs are allocated here with one ``torch.empty``; the kernel
launches on PyTorch's current stream and never synchronises."""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.confidence_gate.kernel import (DTYPE_CODES,
                                                        stats_plan)

_P, _I = ctypes.c_void_p, ctypes.c_int


@functools.cache
def _lib() -> ctypes.CDLL:
    return build.bind("maxconf", {
        "maxconf": [_P, _I, _I, _I, _I, _P, _P],
    })


def maxconf(logits: torch.Tensor) -> dict[str, torch.Tensor]:
    """logits [B, V] f32/bf16 (CUDA, contiguous) -> {prediction [B] i32,
    max_softmax, pcs, entropy [B] f32} (rows of one [4, B] buffer)."""
    build.require_cuda(logits, "logits", DTYPE_CODES, 2)
    b, v = logits.shape
    if b == 0 or v == 0:
        raise ValueError(f"logits {tuple(logits.shape)}: need B, V >= 1")
    out = torch.empty((4, b), dtype=torch.float32, device=logits.device)
    lib = _lib()
    err = build.on_device(logits, lib.maxconf, logits.data_ptr(),
                          DTYPE_CODES[logits.dtype], b, v,
                          stats_plan(b, v, logits.dtype).cluster,
                          out.data_ptr(), build.stream_of(logits))
    build.check(lib, err, "maxconf")
    pred, ms, pcs, ent = out.unbind()
    return {"prediction": pred.view(torch.int32), "max_softmax": ms,
            "pcs": pcs, "entropy": ent}
