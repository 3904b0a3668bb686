"""Plain PyTorch version of the MDSA Mahalanobis distance (any device),
as ``repro.kernels.mdsa.ref.mdsa_ref`` and the einsum of
``repro.core.supervisors.mdsa_confidence`` compute it, in fp32."""

from __future__ import annotations

import torch


def mdsa_ref(x: torch.Tensor, mean: torch.Tensor,
             prec: torch.Tensor) -> torch.Tensor:
    """x: [B, D], mean: [D], prec: [D, D] -> sqrt((x-mu)^T P (x-mu)) [B]."""
    y = x.float() - mean.float()
    d2 = torch.einsum("bd,de,be->b", y, prec.float(), y)
    return torch.sqrt(torch.clamp(d2, min=0.0))
