"""DNN supervisors — confidence monitors for BiSupervised (paper §3.2/§4.2).

Every supervisor maps model metadata to a scalar *confidence* per input
(higher = more trustworthy); a prediction is trusted iff confidence > t.
Uncertainty scores are negated into confidences so thresholding is uniform.

Every supervisor of ``repro.core.supervisors``, as PyTorch functions on
tensors of any device:

  softmax family : MaxSoftmax (vanilla), PCS, negative entropy, Gini
  sampling family: MC-Dropout / Ensemble reducers (variation ratio,
                   mutual information, mean max-softmax)
  surprise family: MDSA (Mahalanobis-distance surprise adequacy); its
                   distance is the ``kernels.mdsa`` kernel on a CUDA tensor
  black-box      : autoencoder reconstruction error
  sequence       : per-token likelihood reducers (min — the paper's pick —
                   and product) for free-text QA / generative decode
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F


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


SOFTMAX_SUPERVISORS = {
    "max_softmax": max_softmax,
    "pcs": prediction_confidence_score,
    "neg_entropy": negative_entropy,
    "gini": gini_confidence,
}


# --------------------------------------------------------------------------
# sampling-based supervisors (metadata = logits [S, B, C] over S samples,
# from MC-Dropout passes or an ensemble — same quantifiers, per paper)
# --------------------------------------------------------------------------

def variation_ratio(sample_logits: torch.Tensor) -> torch.Tensor:
    """Confidence = fraction of samples agreeing with the modal class."""
    preds = sample_logits.argmax(-1)                            # [S, B]
    s, c = preds.shape[0], sample_logits.shape[-1]
    counts = F.one_hot(preds, c).float().sum(0)                 # [B, C]
    return counts.amax(-1) / s


def mutual_information(sample_logits: torch.Tensor) -> torch.Tensor:
    """Confidence = -MI = -(H[mean p] - mean H[p])  (BALD score, negated)."""
    logp = torch.log_softmax(sample_logits.float(), -1)
    p = torch.exp(logp)
    p_mean = p.mean(0)
    h_mean = -torch.sum(p_mean * torch.log(p_mean + 1e-12), -1)
    mean_h = torch.mean(-torch.sum(p * logp, -1), 0)
    return -(h_mean - mean_h)


def mean_max_softmax(sample_logits: torch.Tensor) -> torch.Tensor:
    """Confidence = max of the mean predictive distribution."""
    p = torch.softmax(sample_logits.float(), -1)
    return p.mean(0).amax(-1)


SAMPLING_SUPERVISORS = {
    "variation_ratio": variation_ratio,
    "mutual_information": mutual_information,
    "mean_max_softmax": mean_max_softmax,
}


# --------------------------------------------------------------------------
# MDSA — Mahalanobis-distance surprise adequacy [Kim et al. 2020]
# metadata = activation trace (penultimate hidden) [B, D]
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class MDSAState:
    mean: torch.Tensor      # [D] f32
    prec: torch.Tensor      # [D, D] f32 inverse covariance (precision)


def fit_mdsa(train_activations: torch.Tensor,
             ridge: float = 1e-3) -> MDSAState:
    """Fit mean/precision on *training-set* activation traces (fp32, on
    the activations' device)."""
    a = train_activations.float()
    mu = a.mean(0)
    x = a - mu
    cov = (x.T @ x) / a.shape[0]
    cov = cov + ridge * torch.eye(cov.shape[0], dtype=torch.float32,
                                  device=a.device)
    return MDSAState(mean=mu, prec=torch.linalg.inv(cov).contiguous())


def mdsa_confidence(state: MDSAState,
                    activations: torch.Tensor) -> torch.Tensor:
    """Confidence = -sqrt((x-mu)^T Sigma^-1 (x-mu)) (low surprise =
    trusted)."""
    # imported here: the kernels package imports this module (the gate's
    # plain version reads SOFTMAX_SUPERVISORS)
    from repro_torch.kernels.mdsa.ops import mdsa_distance
    return -mdsa_distance(activations.float().contiguous(), state.mean,
                          state.prec)


# --------------------------------------------------------------------------
# autoencoder supervisor (black-box) [Stocco et al. 2020]
# --------------------------------------------------------------------------

def autoencoder_confidence(params: dict, x: torch.Tensor) -> torch.Tensor:
    """Tiny linear AE: confidence = -reconstruction MSE. params from
    fit_autoencoder. x: [B, D] (input features or embeddings)."""
    z = torch.tanh(x @ params["enc"] + params["enc_b"])
    rec = z @ params["dec"] + params["dec_b"]
    return -torch.mean(torch.square(rec - x), -1)


def fit_autoencoder(gen: torch.Generator, x: torch.Tensor, latent: int = 16,
                    steps: int = 200, lr: float = 1e-2) -> dict:
    """Closed-loop gradient fit of the linear AE on nominal data: ``steps``
    plain gradient steps of size ``lr`` on the mean reconstruction error.
    The initial weights are drawn from ``gen`` (on x's device)."""
    d = x.shape[-1]
    dev = x.device
    params = {
        "enc": torch.randn((d, latent), generator=gen, device=dev)
        / math.sqrt(d),
        "enc_b": torch.zeros(latent, device=dev),
        "dec": torch.randn((latent, d), generator=gen, device=dev)
        / math.sqrt(latent),
        "dec_b": torch.zeros(d, device=dev),
    }
    x = x.detach().float()
    for _ in range(steps):
        leaves = {k: v.requires_grad_(True) for k, v in params.items()}
        loss = -torch.mean(autoencoder_confidence(leaves, x))
        grads = torch.autograd.grad(loss, list(leaves.values()))
        params = {k: (v - lr * g).detach()
                  for (k, v), g in zip(leaves.items(), grads)}
    return params


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


def equivalent_token_confidence(logits: torch.Tensor,
                                groups: torch.Tensor) -> torch.Tensor:
    """IMDB-style 2nd-level supervisor: sum softmax mass over hard-coded
    equivalent tokens (e.g. "Negative"/"negative"/"bad").

    logits: [B, V]; groups: [G, V] 0/1 membership. Returns the mass of the
    best group (the remote model's effective class confidence)."""
    sm = torch.softmax(logits.float(), -1)
    group_mass = sm @ groups.T.float()                       # [B, G]
    return group_mass.amax(-1)
