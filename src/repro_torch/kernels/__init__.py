"""Hand-written CUDA kernels for Hopper (sm_90a) on the cascade's path.

Each kernel package keeps ``kernel.py`` (ctypes wrapper of the CUDA
source under ``csrc/``), ``ops.py`` (dispatch on the tensor's device:
the kernel for a CUDA tensor, the plain version for a CPU tensor) and
``ref.py`` (the plain PyTorch version). ``ops.LAUNCHES`` counts kernel
launches; ``launch_counts``/``reset_launch_counts`` read and clear them
all.
"""

from repro_torch.kernels.build import LAUNCH_LOCK
from repro_torch.kernels.confidence_gate import ops as _gate_ops
from repro_torch.kernels.confidence_gate.ops import confidence_gate
from repro_torch.kernels.flash_attention import ops as _flash_ops
from repro_torch.kernels.flash_attention.ops import attention
from repro_torch.kernels.fused_head_gate import ops as _head_ops
from repro_torch.kernels.fused_head_gate.ops import (FusedLocalHead,
                                                     fused_head_gate)

_COUNTERS = (_gate_ops.LAUNCHES, _head_ops.LAUNCHES, _flash_ops.LAUNCHES)


def launch_counts() -> dict[str, int]:
    out: dict[str, int] = {}
    with LAUNCH_LOCK:
        for c in _COUNTERS:
            out.update(c)
    return out


def reset_launch_counts() -> None:
    with LAUNCH_LOCK:
        for c in _COUNTERS:
            for name in c:
                c[name] = 0


__all__ = ["confidence_gate", "fused_head_gate", "FusedLocalHead",
           "attention", "launch_counts", "reset_launch_counts"]
