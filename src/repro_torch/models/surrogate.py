"""Local surrogate models — the paper's "small, local" tier, in PyTorch.

The paper's local models are tiny custom transformers (one transformer
block + pooling + two dense layers, dropout before the dense layers).
Same recipe and parameter layout as ``repro.models.surrogate``, with
inference-time dropout (MC-Dropout) driven by an explicit
``torch.Generator``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from repro_torch.models.layers import (Params, dense, dense_params, gelu_mlp,
                                       gelu_mlp_params, layer_norm, normal)


@dataclass(frozen=True)
class SurrogateConfig:
    name: str
    vocab_size: int           # input-domain-reduced dictionary
    max_len: int              # input-domain-reduced sequence clip
    d_model: int
    num_heads: int
    d_ff: int
    num_classes: int
    num_blocks: int = 1
    dropout: float = 0.1
    pool: str = "mean"        # mean | first
    norm_eps: float = 1e-5


def init_params(cfg: SurrogateConfig, gen: torch.Generator) -> Params:
    """Random fp32 parameters on ``gen.device``."""
    f32, dev = torch.float32, gen.device
    p: Params = {
        "embed": normal(gen, (cfg.vocab_size, cfg.d_model), f32, 0.02),
        "pos": normal(gen, (cfg.max_len, cfg.d_model), f32, 0.02),
        "hidden": dense_params(gen, cfg.d_model, cfg.d_ff, f32, bias=True),
        "out": dense_params(gen, cfg.d_ff, cfg.num_classes, f32, bias=True),
    }
    ones = lambda: torch.ones(cfg.d_model, device=dev)     # noqa: E731
    zeros = lambda: torch.zeros(cfg.d_model, device=dev)   # noqa: E731
    p["blocks"] = [{
        "ln1_w": ones(), "ln1_b": zeros(),
        "ln2_w": ones(), "ln2_b": zeros(),
        "wq": dense_params(gen, cfg.d_model, cfg.d_model, f32),
        "wk": dense_params(gen, cfg.d_model, cfg.d_model, f32),
        "wv": dense_params(gen, cfg.d_model, cfg.d_model, f32),
        "wo": dense_params(gen, cfg.d_model, cfg.d_model, f32),
        "mlp": gelu_mlp_params(gen, cfg.d_model, cfg.d_ff, f32),
    } for _ in range(cfg.num_blocks)]
    return p


def _mha(cfg: SurrogateConfig, bp: Params, x, mask):
    b, t, d = x.shape
    h = cfg.num_heads
    hd = d // h
    q = dense(bp["wq"], x).reshape(b, t, h, hd)
    k = dense(bp["wk"], x).reshape(b, t, h, hd)
    v = dense(bp["wv"], x).reshape(b, t, h, hd)
    lg = torch.einsum("bthd,bshd->bhts", q, k) / math.sqrt(hd)
    lg = lg.masked_fill(~mask[:, None, None, :], -1e30)
    w = torch.softmax(lg, -1)
    o = torch.einsum("bhts,bshd->bthd", w, v).reshape(b, t, d)
    return dense(bp["wo"], o)


def _dropout(x, rate, gen):
    keep = torch.rand(x.shape, generator=gen, device=x.device) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def apply(cfg: SurrogateConfig, params: Params, tokens: torch.Tensor, *,
          dropout_rng: torch.Generator | None = None, train: bool = False,
          mc_dropout: bool = False, return_hidden: bool = False):
    """tokens: [B, T<=max_len] integer (0 = pad). Returns logits [B, C].

    mc_dropout=True keeps dropout live at inference (MC-Dropout sampling);
    dropout_rng (a generator on the tokens' device) is then required.
    return_hidden additionally returns the penultimate activation.
    """
    use_do = (train or mc_dropout) and cfg.dropout > 0
    if use_do and dropout_rng is None:
        raise ValueError("dropout is live: pass dropout_rng")
    tokens = tokens.long()
    mask = tokens > 0
    t = tokens.shape[1]
    x = params["embed"][tokens] + params["pos"][:t]
    for bp in params["blocks"]:
        h = layer_norm(x, bp["ln1_w"], bp["ln1_b"], cfg.norm_eps)
        x = x + _mha(cfg, bp, h, mask)
        h = layer_norm(x, bp["ln2_w"], bp["ln2_b"], cfg.norm_eps)
        x = x + gelu_mlp(bp["mlp"], h)
        if use_do:
            x = _dropout(x, cfg.dropout, dropout_rng)
    if cfg.pool == "mean":
        denom = torch.clamp(mask.sum(-1, keepdim=True), min=1)
        pooled = torch.sum(x * mask[..., None], 1) / denom
    else:
        pooled = x[:, 0]
    if use_do:
        pooled = _dropout(pooled, cfg.dropout, dropout_rng)
    hidden = torch.relu(dense(params["hidden"], pooled))
    if use_do:
        hidden = _dropout(hidden, cfg.dropout, dropout_rng)
    logits = dense(params["out"], hidden)
    if return_hidden:
        return logits, hidden
    return logits


def loss_fn(cfg: SurrogateConfig, params: Params, tokens, labels,
            rng: torch.Generator | None = None):
    logits = apply(cfg, params, tokens, dropout_rng=rng, train=True)
    labels = labels.long()
    lse = torch.logsumexp(logits, -1)
    gold = torch.gather(logits, -1, labels[:, None])[:, 0]
    loss = torch.mean(lse - gold)
    acc = torch.mean((logits.argmax(-1) == labels).float())
    return loss, {"acc": acc}
