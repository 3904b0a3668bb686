"""ctypes wrappers of the confidence-gate CUDA kernels
(``csrc/confidence_gate.cu``): the score pass and the thresholded
bottom-k select (a rank select in one pass: one warp at B <= 32, a
merge sort of (value, row) keys in shared memory above), and the launch
plan of the vocabulary statistics pass that the score shares with maxconf
(``csrc/vocab_stats.cuh``). Each call allocates its one output buffer
with ``torch.empty``; the kernels launch on PyTorch's current stream and
never synchronise."""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import build

SUPERVISORS = ("max_softmax", "pcs", "neg_entropy", "gini")
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
STATS_INT32S = 6                # one GateStats: 5 floats + 1 int
SM_COUNT = 132                  # H100 SXM
STATS_THREADS = 256             # threads per block of the statistics pass
STATS_ROWS_PER_BLOCK = STATS_THREADS // 32   # narrow rows: a warp each
WIDE_COLS = 4096                # from here a row gets a cluster of blocks
MAX_CLUSTER = 8                 # the portable thread-block cluster size
# the select's sort keeps an 8-byte key per row (rows padded to a power
# of two, one 8-byte gap per 16) in shared memory: 16384 rows fill 136 KB
# of the 227 KB a block has
MAX_SELECT_ROWS = 16384

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


@functools.cache
def _lib() -> ctypes.CDLL:
    return build.bind("confidence_gate", {
        "gate_score": [_P, _I, _I, _I, _I, _I, _P, _P],
        "gate_select": [_P, _I, _P, _P, _I, _P, _P],
    })


def supervisor_code(supervisor: str) -> int:
    if supervisor not in SUPERVISORS:
        raise ValueError(f"unknown supervisor {supervisor!r}; expected one "
                         f"of {SUPERVISORS}")
    return SUPERVISORS.index(supervisor)


class StatsPlan(NamedTuple):
    """How the statistics pass launches for logits [B, C]: ``grid``
    blocks of STATS_THREADS; with ``cluster`` > 0 each row is one
    thread-block cluster of ``cluster`` blocks (block i folds the i-th
    run of the row's 16-byte vectors); with ``cluster`` 0 each row is one
    warp's, STATS_ROWS_PER_BLOCK rows to a block."""
    cluster: int
    grid: int


@functools.cache
def stats_plan(b: int, c: int, dtype: torch.dtype) -> StatsPlan:
    """Narrow rows (C < WIDE_COLS) a warp each; a wide row a cluster of
    as many blocks as the B rows can have with one block per SM, at most
    MAX_CLUSTER, and no more than gives every thread one 16-byte load."""
    if c < WIDE_COLS:
        return StatsPlan(0, -(-b // STATS_ROWS_PER_BLOCK))
    vec = 16 // dtype.itemsize
    cluster = max(1, min(MAX_CLUSTER, SM_COUNT // b,
                         c // (STATS_THREADS * vec)))
    return StatsPlan(cluster, cluster * b)


def gate_score(logits: torch.Tensor, supervisor: str):
    """logits [B, C] f32/bf16 (CUDA, contiguous) -> conf [B] f32,
    pred [B] i32 (rows of one [2, B] buffer)."""
    build.require_cuda(logits, "logits", DTYPE_CODES, 2)
    b, c = logits.shape
    if b == 0 or c == 0:
        raise ValueError(f"empty logits {tuple(logits.shape)}")
    sup = supervisor_code(supervisor)
    out = torch.empty((2, b), dtype=torch.float32, device=logits.device)
    lib = _lib()
    err = build.on_device(logits, lib.gate_score, logits.data_ptr(),
                          DTYPE_CODES[logits.dtype], b, c,
                          stats_plan(b, c, logits.dtype).cluster, sup,
                          out.data_ptr(), build.stream_of(logits))
    build.check(lib, err, "gate_score")
    conf, pred = out.unbind()
    return conf, pred.view(torch.int32)


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
    err = build.on_device(conf, lib.gate_select, conf.data_ptr(), b,
                          t_local.data_ptr(), n_valid.data_ptr(), k,
                          idx.data_ptr(), build.stream_of(conf))
    build.check(lib, err, "gate_select")
    return idx
