"""Plain PyTorch version of the confidence gate (any device).

Semantics shared with the CUDA kernels (kernel.py):

  * score every row of a logits batch with one softmax-family supervisor
    (or any callable ``logits -> confidence``) and take its argmax (first
    index on ties);
  * select up to ``k`` escalation candidates: the lowest-confidence rows,
    ascending by confidence (ties broken by lowest row index — a stable
    sort), restricted to rows ``< n_valid`` and to ``conf < t_local`` when
    a threshold is given; unused slots are ``-1``.
"""

from __future__ import annotations

import math

import torch

from repro_torch.core.supervisors import SOFTMAX_SUPERVISORS


def select_ref(conf: torch.Tensor, t_local=None, n_valid=None,
               k: int | None = None) -> torch.Tensor:
    """Thresholded ascending bottom-k of conf [B] -> idx [k] int32."""
    b = conf.shape[0]
    k = b if k is None else min(int(k), b)
    dev = conf.device
    t = torch.as_tensor(math.inf if t_local is None else t_local,
                        dtype=torch.float32, device=dev)
    n = torch.as_tensor(b if n_valid is None else n_valid,
                        dtype=torch.int32, device=dev)
    rows = torch.arange(b, device=dev)
    masked = torch.where(rows < n, conf.float(),
                         torch.tensor(math.inf, device=dev))
    order = torch.sort(masked, stable=True).indices[:k]
    # eligible rows form a prefix of the ascending order
    count = (masked[order] < t).sum()
    return torch.where(torch.arange(k, device=dev) < count, order,
                       -1).to(torch.int32)


def confidence_gate_ref(logits: torch.Tensor, t_local=None, n_valid=None, *,
                        supervisor="max_softmax",
                        k: int | None = None) -> dict[str, torch.Tensor]:
    """logits [B, C] -> {conf [B] f32, pred [B] i32, idx [k] i32}."""
    sup = (supervisor if callable(supervisor)
           else SOFTMAX_SUPERVISORS[supervisor])
    conf = sup(logits).float()
    pred = logits.argmax(-1).to(torch.int32)
    return {"conf": conf, "pred": pred,
            "idx": select_ref(conf, t_local, n_valid, k)}
