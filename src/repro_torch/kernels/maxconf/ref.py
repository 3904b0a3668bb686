"""Plain PyTorch version of the fused supervisor-confidence pass (any
device): the four outputs from a log-softmax in fp32, as
``repro.kernels.maxconf.ref`` computes them."""

from __future__ import annotations

import torch


def maxconf_ref(logits: torch.Tensor) -> dict[str, torch.Tensor]:
    """logits: [B, V] -> per-row supervisor metadata: prediction (argmax,
    first index on ties), max_softmax, pcs (top1 - top2 softmax), entropy."""
    lg = logits.float()
    logp = torch.log_softmax(lg, -1)
    p = torch.exp(logp)
    top2 = torch.topk(p, 2, dim=-1).values
    return {
        "prediction": lg.argmax(-1).to(torch.int32),
        "max_softmax": top2[:, 0],
        "pcs": top2[:, 0] - top2[:, 1],
        "entropy": -torch.sum(p * logp, -1),
    }
