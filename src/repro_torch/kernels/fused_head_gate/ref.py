"""Plain PyTorch version of the fused local-head -> confidence-gate op:
project (fp32), then gate. The CUDA kernel matches it exactly on pred/idx
and to float tolerance on conf (same online-softmax algebra, another
summation order)."""

from __future__ import annotations

import torch

from repro_torch.kernels.confidence_gate.ref import confidence_gate_ref


def head_logits(hidden: torch.Tensor, w: torch.Tensor,
                bias: torch.Tensor | None = None) -> torch.Tensor:
    logits = hidden.float() @ w.float()
    if bias is not None:
        logits = logits + bias.float()[None, :]
    return logits


def fused_head_gate_ref(hidden: torch.Tensor, w: torch.Tensor,
                        bias: torch.Tensor | None = None, t_local=None,
                        n_valid=None, *, supervisor="max_softmax",
                        k: int | None = None) -> dict[str, torch.Tensor]:
    """hidden [B, D], w [D, C], bias [C] or None -> {conf, pred, idx}."""
    return confidence_gate_ref(head_logits(hidden, w, bias), t_local,
                               n_valid, supervisor=supervisor, k=k)
