"""ctypes wrappers of the confidence-gate CUDA kernels
(``csrc/confidence_gate.cu``): the score pass and the thresholded
bottom-k select. Outputs and scratch are allocated here with
``torch.empty``; the kernels launch on PyTorch's current stream and never
synchronise."""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

SUPERVISORS = ("max_softmax", "pcs", "neg_entropy", "gini")
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
STATS_INT32S = 6                # one GateStats: 5 floats + 1 int
SPLIT_COLS = 2048               # class columns folded by one score block
MAX_SPLITS = 256
MAX_SELECT_ROWS = 12288         # select keeps conf in 48 KB of shared memory

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


@functools.cache
def _lib() -> ctypes.CDLL:
    return build.bind("confidence_gate", {
        "gate_score": [_P, _I, _I, _I, _I, _I, _P, _P, _P, _P],
        "gate_select": [_P, _I, _P, _P, _I, _P, _P],
    })


def supervisor_code(supervisor: str) -> int:
    if supervisor not in SUPERVISORS:
        raise ValueError(f"unknown supervisor {supervisor!r}; expected one "
                         f"of {SUPERVISORS}")
    return SUPERVISORS.index(supervisor)


def score_splits(c: int) -> int:
    return max(1, min(MAX_SPLITS, -(-c // SPLIT_COLS)))


def gate_score(logits: torch.Tensor, supervisor: str):
    """logits [B, C] f32/bf16 (CUDA, contiguous) -> conf [B] f32,
    pred [B] i32."""
    build.require_cuda(logits, "logits", DTYPE_CODES, 2)
    b, c = logits.shape
    if b == 0 or c == 0:
        raise ValueError(f"empty logits {tuple(logits.shape)}")
    sup = supervisor_code(supervisor)
    nsplit = score_splits(c)
    dev = logits.device
    part = torch.empty(b * nsplit * STATS_INT32S, dtype=torch.int32,
                       device=dev)
    conf = torch.empty(b, dtype=torch.float32, device=dev)
    pred = torch.empty(b, dtype=torch.int32, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        err = lib.gate_score(build.ptr(logits), DTYPE_CODES[logits.dtype], b,
                             c, nsplit, sup, build.ptr(part), build.ptr(conf),
                             build.ptr(pred), build.stream_of(logits))
    build.check(lib, err, "gate_score")
    return conf, pred


def gate_select(conf: torch.Tensor, t_local: torch.Tensor,
                n_valid: torch.Tensor, k: int) -> torch.Tensor:
    """conf [B] f32, device scalars t_local (f32) and n_valid (i32) ->
    idx [k] i32."""
    build.require_cuda(conf, "conf", (torch.float32,), 1)
    build.require_cuda(t_local, "t_local", (torch.float32,), 0)
    build.require_cuda(n_valid, "n_valid", (torch.int32,), 0)
    if t_local.device != conf.device or n_valid.device != conf.device:
        raise ValueError("conf, t_local and n_valid must share a device")
    b = conf.shape[0]
    if not 1 <= k <= b or b > MAX_SELECT_ROWS:
        raise ValueError(f"select needs 1 <= k <= B <= {MAX_SELECT_ROWS}, "
                         f"got k={k}, B={b}")
    idx = torch.empty(k, dtype=torch.int32, device=conf.device)
    lib = _lib()
    with torch.cuda.device(conf.device):
        err = lib.gate_select(build.ptr(conf), b, build.ptr(t_local),
                              build.ptr(n_valid), k, build.ptr(idx),
                              build.stream_of(conf))
    build.check(lib, err, "gate_select")
    return idx
