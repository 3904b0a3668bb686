"""ctypes wrapper of the MDSA Mahalanobis-distance CUDA kernel
(``csrc/mdsa.cu``) and its launch plan. The output and the per-block
partials are allocated here with ``torch.empty``; the kernels launch on
PyTorch's current stream and never synchronise. The plan is cached per
shape."""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import build

ROW_TILE = 128                  # batch rows per block
COL_TILE = 128                  # columns j per block (wgmma's N)
DEPTH_STEP = 32                 # depth per pipeline step (slices: whole steps)
MIN_SLICE_STEPS = 4             # fewest steps a depth slice runs
MAX_ROW_TILES = 65535           # the grid's y limit
SM_COUNT = 132                  # H100 SXM
RESIDENT = 1                    # blocks per SM (154 KB shared memory each)

_P, _I = ctypes.c_void_p, ctypes.c_int


@functools.cache
def _lib() -> ctypes.CDLL:
    return build.bind("mdsa", {"mdsa": [_P, _P, _P, _P, _P, _I, _I, _I, _I,
                                        _P]})


class MdsaPlan(NamedTuple):
    """How ``mdsa`` launches: ``row_tiles`` x ``col_tiles`` x ``splits``
    blocks; block (jt, mt, s) owns rows [mt*ROW_TILE, +ROW_TILE) of B,
    columns [jt*COL_TILE, +COL_TILE) of D and depth [s*slice_len,
    +slice_len) of D, each clipped at the edge; ``parts`` partial sums
    per row."""
    row_tiles: int
    col_tiles: int
    splits: int
    slice_len: int

    @property
    def parts(self) -> int:
        return self.splits * self.col_tiles


@functools.cache
def plan(b: int, d: int) -> MdsaPlan:
    """The plan for x [b, d]: the depth is cut into as many slices as
    the tiles need to fill one wave of RESIDENT blocks per SM, each slice
    at least MIN_SLICE_STEPS steps deep (so its copy ring has something
    to overlap), and no slice empty."""
    mt, nt = -(-b // ROW_TILE), -(-d // COL_TILE)
    steps = -(-d // DEPTH_STEP)
    want = max(1, SM_COUNT * RESIDENT // (mt * nt))
    per = max(MIN_SLICE_STEPS, -(-steps // want))
    return MdsaPlan(mt, nt, -(-steps // per), per * DEPTH_STEP)


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
    p = plan(b, d)
    # one buffer: the output, then the partials
    buf = torch.empty(b * (1 + p.parts), dtype=torch.float32, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        err = lib.mdsa(x.data_ptr(), mean.data_ptr(), prec.data_ptr(),
                       buf.data_ptr() + 4 * b, buf.data_ptr(), b, d,
                       p.splits, p.slice_len, build.stream_of(x))
    build.check(lib, err, "mdsa")
    return buf[:b]
