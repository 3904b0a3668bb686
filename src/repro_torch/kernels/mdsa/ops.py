"""Public wrapper of the MDSA Mahalanobis distance: a CPU tensor goes to
the plain version (``ref.py``), a CUDA tensor launches the CUDA kernel or
raises. ``LAUNCHES`` counts the kernel launches, one per wrapper call.
Unlike ``repro.kernels.mdsa.ops.mdsa_distance`` nothing is padded: the
kernel masks any B and D itself."""

from __future__ import annotations

import torch

from repro_torch.kernels.build import count_launch, refuse_grad
from repro_torch.kernels.mdsa import kernel
from repro_torch.kernels.mdsa.ref import mdsa_ref

LAUNCHES = {"mdsa": 0}


def mdsa_distance(x: torch.Tensor, mean: torch.Tensor,
                  prec: torch.Tensor) -> torch.Tensor:
    """x: [B, D], mean: [D], prec: [D, D] -> Mahalanobis distance [B]."""
    if x.device.type == "cpu":
        return mdsa_ref(x, mean, prec)
    refuse_grad("mdsa", x, mean, prec)
    out = kernel.mdsa(x, mean, prec)
    count_launch(LAUNCHES, "mdsa")
    return out
