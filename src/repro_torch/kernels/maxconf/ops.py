"""Public wrapper of the fused supervisor-confidence pass: a CPU tensor
goes to the plain version (``ref.py``), a CUDA tensor launches the CUDA
kernel or raises. ``LAUNCHES`` counts the kernel launches, one per
wrapper call."""

from __future__ import annotations

import torch

from repro_torch.kernels.build import count_launch, refuse_grad
from repro_torch.kernels.maxconf import kernel
from repro_torch.kernels.maxconf.ref import maxconf_ref

LAUNCHES = {"maxconf": 0}


def maxconf(logits: torch.Tensor) -> dict[str, torch.Tensor]:
    """logits [B, V] -> {prediction, max_softmax, pcs, entropy} per row."""
    if logits.device.type == "cpu":
        return maxconf_ref(logits)
    refuse_grad("maxconf", logits)
    out = kernel.maxconf(logits)
    count_launch(LAUNCHES, "maxconf")
    return out
