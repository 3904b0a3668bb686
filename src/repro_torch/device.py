"""Device selection for the port's entry points.

Every entry point takes an explicit ``device`` that defaults to ``"cuda"``.
A CUDA device asked for where none is present raises: the port never
carries on quietly on the CPU. Tests and CPU runs pass ``"cpu"``.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but no CUDA device is "
            f"available (torch.cuda.is_available() is False); pass "
            f"device='cpu' to run on the CPU")
    return dev
