"""DNN supervisors — confidence monitors for BiSupervised (paper §3.2/§4.2).

Every supervisor maps model metadata to a scalar *confidence* per input
(higher = more trustworthy); a prediction is trusted iff confidence > t.
Uncertainty scores are negated into confidences so thresholding is uniform.

This module holds the softmax family (metadata = logits [B, C]) and the
sequence reducers over generated answers (metadata = per-token
likelihoods [B, T]) as plain PyTorch functions on tensors of any device.
The sampling, MDSA and autoencoder supervisors of
``repro.core.supervisors`` come with a later slice of the port.
"""

from __future__ import annotations

import torch


def max_softmax(logits: torch.Tensor) -> torch.Tensor:
    """Vanilla softmax / MaxSoftmax [Hendrycks & Gimpel 2016]."""
    return torch.softmax(logits.float(), -1).amax(-1)


def prediction_confidence_score(logits: torch.Tensor) -> torch.Tensor:
    """PCS: difference between the two highest likelihoods [Zhang et al.]."""
    sm = torch.softmax(logits.float(), -1)
    top2 = torch.topk(sm, 2, dim=-1).values
    return top2[..., 0] - top2[..., 1]


def negative_entropy(logits: torch.Tensor) -> torch.Tensor:
    """Confidence = -H(softmax) [Weiss & Tonella 2021]."""
    logp = torch.log_softmax(logits.float(), -1)
    return torch.sum(torch.exp(logp) * logp, -1)


def gini_confidence(logits: torch.Tensor) -> torch.Tensor:
    """Confidence = sum p^2 (1 - Gini impurity) [DeepGini, Feng et al.]."""
    sm = torch.softmax(logits.float(), -1)
    return torch.sum(sm * sm, -1)


# --------------------------------------------------------------------------
# sequence reducers (free-text QA; metadata = per-token likelihood [B, T])
# --------------------------------------------------------------------------

def seq_min_likelihood(token_likelihoods: torch.Tensor,
                       mask: torch.Tensor | None = None) -> torch.Tensor:
    """Paper's recommended reducer: min over predicted-token likelihoods
    (length-robust, unlike the product)."""
    lk = token_likelihoods.float()
    if mask is not None:
        lk = torch.where(mask > 0, lk, torch.ones_like(lk))
    return lk.amin(-1)


def seq_prod_likelihood(token_likelihoods: torch.Tensor,
                        mask: torch.Tensor | None = None) -> torch.Tensor:
    """Product reducer (literature default; length-biased — paper §5.3.4)."""
    lk = torch.log(torch.clamp(token_likelihoods.float(), 1e-12, 1.0))
    if mask is not None:
        lk = lk * (mask > 0)
    return torch.exp(lk.sum(-1))


SOFTMAX_SUPERVISORS = {
    "max_softmax": max_softmax,
    "pcs": prediction_confidence_score,
    "neg_entropy": negative_entropy,
    "gini": gini_confidence,
}
