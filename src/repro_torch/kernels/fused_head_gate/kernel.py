"""ctypes wrapper of the fused head -> gate CUDA kernel
(``csrc/fused_head_gate.cu``) and its launch plan. One launch per call:
the logits live only in registers and shared memory, and the kernel
writes conf and pred; the gate's select kernel ranks the rows. Each call
allocates its one output buffer; the wide forms' merge scratch (a ticket
per 32 rows and the clusters' partial statistics) is allocated and
zeroed once per device, stream and ticket region, and the kernel leaves
the tickets zero."""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.confidence_gate.kernel import (DTYPE_CODES,
                                                        SM_COUNT,
                                                        STATS_INT32S,
                                                        supervisor_code)

FORMS = ("narrow", "mma", "fma")   # FORM_* in the source, in this order
HEAD_ROWS = 32                     # batch rows per block of the wide forms
NARROW_COLS = 32                   # narrow: a lane per column
MMA_WARP_COLS = 16                 # one m16n8k16 tile of columns
MMA_WARPS = 8
FMA_TILE_COLS = 256                # kFmaCols in the source
# blocks merged through distributed shared memory: at one block per SM
# clusters of 4 or 8 did not all fit at once on the H100 and ran in two
# waves (PERF.md)
HEAD_CLUSTER = 2

_P, _I = ctypes.c_void_p, ctypes.c_int


@functools.cache
def _lib() -> ctypes.CDLL:
    return build.bind("fused_head_gate", {
        "fused_head_gate": [_P, _I, _P, _I, _P, _I, _I, _I, _I, _I, _I, _I,
                            _I, _P, _P, _P, _P],
    })


class HeadPlan(NamedTuple):
    """How the head gate launches for hidden [B, D] x w [D, C].
    ``narrow``: one warp per row, ``grid`` blocks of one. ``mma``
    (bf16 w, rows 16-byte aligned) and ``fma``: ``grid`` column blocks of
    ``tile_cols`` columns (``mt`` 16-column tiles per warp for ``mma``),
    a multiple of ``cluster``, times ``groups`` blocks of 32 rows;
    ``scratch`` int32s of merge scratch (``groups`` tickets first)."""
    form: str
    mt: int
    tile_cols: int
    grid: int
    cluster: int
    groups: int
    scratch: int


@functools.cache
def head_plan(b: int, d: int, c: int, h_dtype: torch.dtype,
              w_dtype: torch.dtype, w_aligned: bool = True) -> HeadPlan:
    """The narrow form up to NARROW_COLS columns; else the tensor cores
    for bf16 w whose rows start on 16 bytes (C % 8 == 0 and an aligned
    base), with the widest tile that still gives three quarters of the
    SMs a block: MT 4, 2 or 1 for an f32 hidden (three products a step),
    at most 2 for a bf16 one (two blocks an SM: one product a step
    leaves the block waiting on its barrier, measured on the H100 in
    PERF.md); the FMA tile otherwise."""
    if c <= NARROW_COLS:
        return HeadPlan("narrow", 0, 0, b, 0, 0, 0)
    if w_dtype == torch.bfloat16 and c % 8 == 0 and w_aligned:
        for mt in (4, 2, 1) if h_dtype == torch.float32 else (2, 1):
            cols = MMA_WARPS * MMA_WARP_COLS * mt
            if -(-c // cols) >= SM_COUNT * 3 // 4:
                break
        form = "mma"
    else:
        form, mt, cols = "fma", 0, FMA_TILE_COLS
    tiles = -(-c // cols)
    cluster = min(HEAD_CLUSTER, tiles)
    grid = -(-tiles // cluster) * cluster
    groups = -(-b // HEAD_ROWS)
    scratch = _ticket_ints(groups) + groups * (grid // cluster) * HEAD_ROWS \
        * STATS_INT32S
    return HeadPlan(form, mt, cols, grid, cluster, groups, scratch)


def _ticket_ints(groups: int) -> int:
    """int32s of tickets, rounded up so the partials start on 32 bytes."""
    return -(-groups // 8) * 8


_SCRATCH: dict = {}  # (device index, raw stream, ticket int32s) -> int32s


def _scratch(dev: torch.device, stream: int, tickets: int,
             n: int) -> torch.Tensor:
    """The merge scratch of ``dev`` for kernels on ``stream`` whose plan
    has ``tickets`` int32s of tickets: made and zeroed on first use (or
    when a larger plan needs more); each kernel leaves its tickets zero,
    so it is never cleared again. Plans with another ticket region get a
    buffer of their own: their tickets would fall on an earlier plan's
    partial statistics."""
    key = (dev.index, stream, tickets)
    buf = _SCRATCH.get(key)
    if buf is None or buf.numel() < n:
        buf = _SCRATCH[key] = torch.zeros(n, dtype=torch.int32, device=dev)
    return buf


def fused_head_gate(hidden: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                    supervisor: str):
    """hidden [B, D], w [D, C] (f32/bf16, CUDA, contiguous), bias [C] f32
    -> conf [B] f32, pred [B] i32 (rows of one [2, B] buffer)."""
    build.require_cuda(hidden, "hidden", DTYPE_CODES, 2)
    build.require_cuda(w, "w", DTYPE_CODES, 2)
    build.require_cuda(bias, "bias", (torch.float32,), 1)
    b, d = hidden.shape
    dw, c = w.shape
    if d != dw or bias.shape[0] != c or b == 0 or d == 0 or c == 0:
        raise ValueError(f"shapes hidden {tuple(hidden.shape)}, w "
                         f"{tuple(w.shape)}, bias {tuple(bias.shape)}")
    if not hidden.device == w.device == bias.device:
        raise ValueError("hidden, w and bias must share a device")
    sup = supervisor_code(supervisor)
    plan = head_plan(b, d, c, hidden.dtype, w.dtype,
                     w.data_ptr() % 16 == 0)
    dev = hidden.device
    out = torch.empty((2, b), dtype=torch.float32, device=dev)
    stream = build.stream_of(hidden)
    ticket = part = 0
    if plan.form != "narrow":
        tickets = _ticket_ints(plan.groups)
        ticket = _scratch(dev, stream, tickets, plan.scratch).data_ptr()
        part = ticket + 4 * tickets
    lib = _lib()
    err = build.on_device(
        hidden, lib.fused_head_gate, hidden.data_ptr(),
        DTYPE_CODES[hidden.dtype], w.data_ptr(), DTYPE_CODES[w.dtype],
        bias.data_ptr(), b, d, c, FORMS.index(plan.form), plan.tile_cols,
        plan.grid, plan.cluster, sup, ticket, part, out.data_ptr(), stream)
    build.check(lib, err, "fused_head_gate")
    conf, pred = out.unbind()
    return conf, pred.view(torch.int32)
