"""BiSupervised cascade orchestration (paper §4, Algorithm 1), in PyTorch.

* ``bisupervised_batch`` — exact Algorithm-1 semantics, vectorised over a
  batch (threshold branches become masks).
* ``select_escalations`` / ``gather_requests`` / ``combine_escalated`` —
  the fixed-capacity serving adaptation: the k lowest-confidence requests
  are gathered into a sub-batch for the remote tier.

Ties in ``select_escalations`` go to the lower row index, as
``jax.lax.top_k(-conf, k)`` orders them in ``repro.core.cascade``:
``torch.topk`` promises no tie order, so a stable sort does the ranking.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

LOCAL, REMOTE, REJECTED = 0, 1, 2


@dataclass(frozen=True)
class CascadeThresholds:
    """Runtime-tunable supervisor thresholds (paper §4.5)."""
    t_local: float
    t_remote: float


def bisupervised_batch(local_pred: torch.Tensor, local_conf: torch.Tensor,
                       remote_pred: torch.Tensor, remote_conf: torch.Tensor,
                       th: CascadeThresholds) -> dict[str, torch.Tensor]:
    """Vectorised Algorithm 1: prediction, source (LOCAL / REMOTE /
    REJECTED), accepted (False = fallback) and remote_called per input."""
    use_local = local_conf > th.t_local
    remote_ok = remote_conf > th.t_remote
    prediction = torch.where(use_local, local_pred, remote_pred)
    source = torch.where(use_local, LOCAL,
                         torch.where(remote_ok, REMOTE, REJECTED))
    return {
        "prediction": prediction,
        "source": source,
        "accepted": use_local | remote_ok,
        "remote_called": ~use_local,
    }


def escalation_capacity(batch: int, rho: float) -> int:
    """k = ceil(rho * B), clipped to [1, B]."""
    return max(1, min(batch, int(-(-rho * batch // 1))))


def select_escalations(local_conf: torch.Tensor, k: int):
    """Pick the k lowest-confidence requests.

    Returns (idx [k] int64 — ascending by confidence, lower index first on
    ties; escalate_mask [B] bool)."""
    order = torch.sort(local_conf, stable=True).indices
    idx = order[:k]
    mask = torch.zeros(local_conf.shape[0], dtype=torch.bool,
                       device=local_conf.device)
    mask[idx] = True
    return idx, mask


def gather_requests(batch: Any, idx: torch.Tensor) -> Any:
    """Gather the escalated sub-batch from a (nested dict of) tensors."""
    if isinstance(batch, dict):
        return {k: gather_requests(v, idx) for k, v in batch.items()}
    return batch[idx]


def combine_escalated(local_pred: torch.Tensor, idx: torch.Tensor,
                      remote_pred: torch.Tensor) -> torch.Tensor:
    """Scatter the remote predictions for the escalated indices over the
    local predictions (out of place)."""
    out = local_pred.clone()
    out[idx] = remote_pred.to(out.dtype)
    return out
