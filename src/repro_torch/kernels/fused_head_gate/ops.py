"""Public wrapper of the fused local-head -> gate op.

A CPU tensor goes to the plain version (``ref.py``); a CUDA tensor
launches the fused CUDA kernel (one device kernel) and the gate's select
kernel, or raises.
``LAUNCHES`` counts the fused kernel's launches (the select launch counts
under ``confidence_gate.ops.LAUNCHES``).

``FusedLocalHead`` is the engine-facing carrier: a local model split as
``trunk`` (inputs -> hidden [B, D]) plus the final projection ``(w
[D, C], bias [C])``. ``CascadeEngine`` accepts it wherever a plain
``local_apply`` is accepted and routes the gate through this op.
"""

from __future__ import annotations

from collections.abc import Callable
from dataclasses import dataclass

import torch

from repro_torch.kernels.build import count_launch, refuse_grad
from repro_torch.kernels.confidence_gate.ops import select
from repro_torch.kernels.fused_head_gate import kernel
from repro_torch.kernels.fused_head_gate.ref import (fused_head_gate_ref,
                                                     head_logits)

LAUNCHES = {"fused_head_gate": 0}
_ZERO_BIAS: dict = {}       # (C, device) -> zeros [C] f32, made once


def _zero_bias(c: int, device: torch.device) -> torch.Tensor:
    """The kernel's bias for ``bias=None``: a zero vector kept per (C,
    device) rather than made on every call (nothing writes it)."""
    key = (c, device)
    zero = _ZERO_BIAS.get(key)
    if zero is None:
        zero = _ZERO_BIAS[key] = torch.zeros(c, dtype=torch.float32,
                                             device=device)
    return zero


@dataclass(frozen=True)
class FusedLocalHead:
    """Local model split for head->gate fusion: ``trunk`` maps the local
    input batch to hidden states [B, D]; ``(w, bias)`` is the final
    projection the fused kernel folds into the gate's scoring pass.

    Calling it composes the pieces: a drop-in ``local_apply`` that
    materialises the full logits.
    """

    trunk: Callable[[torch.Tensor], torch.Tensor]
    w: torch.Tensor                                        # [D, C]
    bias: torch.Tensor | None = None                       # [C]

    def __call__(self, local_batch) -> torch.Tensor:
        return head_logits(self.trunk(local_batch), self.w, self.bias)


def fused_head_gate(hidden: torch.Tensor, w: torch.Tensor,
                    bias: torch.Tensor | None = None, t_local=None,
                    n_valid=None, *, supervisor="max_softmax",
                    k: int | None = None) -> dict[str, torch.Tensor]:
    """hidden [B, D], w [D, C], bias [C]|None -> {conf [B], pred [B],
    idx [k]} without materialising the [B, C] logits in device memory.
    Same contract as ``confidence_gate``."""
    b, d = hidden.shape
    if d != w.shape[0]:
        raise ValueError(f"hidden dim {d} != head dim {w.shape[0]}")
    k = b if k is None else min(int(k), b)
    if hidden.device.type == "cpu":
        return fused_head_gate_ref(hidden, w, bias, t_local, n_valid,
                                   supervisor=supervisor, k=k)
    if callable(supervisor):
        raise ValueError("the fused head gate scores the softmax family "
                         "only; pass a callable supervisor to "
                         "confidence_gate on the materialised logits")
    refuse_grad("fused_head_gate", hidden, w, bias)
    if bias is None:
        bias = _zero_bias(w.shape[1], w.device)
    elif bias.dtype != torch.float32 or not bias.is_contiguous():
        bias = bias.float().contiguous()
    conf, pred = kernel.fused_head_gate(hidden, w, bias, supervisor)
    count_launch(LAUNCHES, "fused_head_gate")
    return {"conf": conf, "pred": pred,
            "idx": select(conf, t_local, n_valid, k)}
