"""Hand-written CUDA kernels for Hopper (sm_90a) on the cascade's serving
and generate paths, the RWKV6 time mix and the MDSA supervisor.

Each kernel package keeps ``kernel.py`` (ctypes wrapper of the CUDA
source under ``csrc/``), ``ops.py`` (dispatch on the tensor's device:
the kernel for a CUDA tensor, the plain version for a CPU tensor) and
``ref.py`` (the plain PyTorch version). ``ops.LAUNCHES`` counts kernel
launches; ``launch_counts``/``reset_launch_counts`` read and clear them
all; ``add_launch_counts`` adds to them (a CUDA graph's replay: the
wrappers count while it is captured, and the launches replay without
them). A wrapper named like its package (``confidence_gate``, ``maxconf``,
``rwkv6_scan``) is imported from that package's ``ops``, so that no
function here shadows a subpackage.
"""

from repro_torch.kernels.build import LAUNCH_LOCK
from repro_torch.kernels.confidence_gate import ops as _gate_ops
from repro_torch.kernels.decode_attention import ops as _decode_ops
from repro_torch.kernels.decode_attention.ops import decode_attn
from repro_torch.kernels.flash_attention import ops as _flash_ops
from repro_torch.kernels.flash_attention.ops import attention
from repro_torch.kernels.fused_head_gate import ops as _head_ops
from repro_torch.kernels.fused_head_gate.ops import (FusedLocalHead,
                                                     fused_head_gate)
from repro_torch.kernels.maxconf import ops as _maxconf_ops
from repro_torch.kernels.mdsa import ops as _mdsa_ops
from repro_torch.kernels.mdsa.ops import mdsa_distance
from repro_torch.kernels.rwkv6_scan import ops as _rwkv_ops

_COUNTERS = (_gate_ops.LAUNCHES, _head_ops.LAUNCHES, _flash_ops.LAUNCHES,
             _decode_ops.LAUNCHES, _maxconf_ops.LAUNCHES, _mdsa_ops.LAUNCHES,
             _rwkv_ops.LAUNCHES)


def launch_counts() -> dict[str, int]:
    out: dict[str, int] = {}
    with LAUNCH_LOCK:
        for c in _COUNTERS:
            out.update(c)
    return out


def add_launch_counts(delta: dict[str, int]) -> None:
    """Add ``delta`` (kernel name -> launches, negative to take away) to
    the counters."""
    with LAUNCH_LOCK:
        for c in _COUNTERS:
            for name in c.keys() & delta.keys():
                c[name] += delta[name]


def reset_launch_counts() -> None:
    with LAUNCH_LOCK:
        for c in _COUNTERS:
            for name in c:
                c[name] = 0


__all__ = ["fused_head_gate", "FusedLocalHead", "attention", "decode_attn",
           "mdsa_distance", "launch_counts", "add_launch_counts",
           "reset_launch_counts"]
