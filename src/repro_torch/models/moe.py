"""Mixture-of-Experts layer, in PyTorch: top-k router and capacity-based
dispatch, the function of ``repro.models.moe`` for one dispatch group.

The router is an fp32 ``dense`` even in a bf16 model; its softmax picks
the top-k experts of each token and renormalises their probabilities,
and the Switch load-balance loss is computed over all tokens. Each
expert takes at most ``cap`` (token, slot) pairs: a pair's place in its
expert's queue is the count of earlier pairs with that expert in the
token-major flattening ``[m*k]`` of the top-k ids, and a pair at or past
``cap`` is dropped (weight 0), as JAX's cumsum over the one-hot ids
decides. ``dropless`` sets ``cap = m``, so nothing drops (the serving
paths: a crowded prefill and a one-token decode then route alike).

JAX fills an expert-major buffer ``[E, cap, D]`` and runs the stacked
experts over all of it. The port runs each expert's swiglu only on the
rows routed to it: the (token, slot) pairs that are kept, sorted by
expert (one host sync a layer for the counts), gathered, multiplied and
scattered back. Each row's product is the one JAX computes for it; the
dense buffer at the generate prefill (8 x 512 tokens, ``cap = m``)
would be 1.07 GB a layer for deepseek-v2-lite and 64/6 times the
products. Outputs are combined per token in slot order, weighted by the
renormalised probabilities cast to the activations' dtype, and the
shared experts (one swiglu of width ``num_shared_experts * moe_d_ff``)
are added last. The expert products are ``torch.matmul``: JAX computes
them outside any Pallas kernel.

One dispatch group only: JAX sizes its groups from the ambient mesh's
``data`` axis (``shard_hints``), which the port does not have yet.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import (Params, dense_params, normal, swiglu,
                                       swiglu_params)


def moe_params(gen: torch.Generator, cfg: ModelConfig, dtype,
               stack: tuple = ()) -> Params:
    """``repro.models.moe.moe_params``'s tree: an fp32 router
    ``[D, E]``, stacked experts ``w_gate``/``w_up`` ``[E, D, F]`` and
    ``w_down`` ``[E, F, D]``, and ``shared`` when the config has shared
    experts. ``stack`` prepends leading dims."""
    e, d, f = cfg.num_experts, cfg.d_model, cfg.moe_d_ff
    p = {
        "router": dense_params(gen, d, e, torch.float32, stack=stack),
        "w_gate": normal(gen, (*stack, e, d, f), dtype, 1.0 / math.sqrt(d)),
        "w_up": normal(gen, (*stack, e, d, f), dtype, 1.0 / math.sqrt(d)),
        "w_down": normal(gen, (*stack, e, f, d), dtype, 1.0 / math.sqrt(f)),
    }
    if cfg.num_shared_experts:
        p["shared"] = swiglu_params(gen, d, cfg.num_shared_experts * f,
                                    dtype, stack=stack)
    return p


def capacity(cfg: ModelConfig, m: int,
             capacity_factor: float | None = None) -> int:
    """Per-expert capacity for ``m`` tokens when pairs may drop:
    ``max(int(m * k * cf / E), 1)`` rounded up to a multiple of 8."""
    cf = cfg.capacity_factor if capacity_factor is None else capacity_factor
    cap = max(int(m * cfg.num_experts_per_tok * cf / cfg.num_experts), 1)
    return (cap + 7) // 8 * 8


def route(cfg: ModelConfig, p: Params, xf: torch.Tensor):
    """xf: [m, D] -> (top_e [m, k] int64, top_p [m, k] fp32 renormalised,
    aux 0-d fp32)."""
    e, k = cfg.num_experts, cfg.num_experts_per_tok
    logits = xf.float() @ p["router"]["w"].float()                # [m, E]
    probs = torch.softmax(logits, -1)
    top_p, top_e = torch.topk(probs, k, dim=-1)
    top_p = top_p / top_p.sum(-1, keepdim=True)
    me = probs.mean(0)
    ce = F.one_hot(top_e, e).float().sum(1).mean(0) / k
    return top_e, top_p, e * torch.sum(me * ce)


def keep_mask(top_e: torch.Tensor, e: int, cap: int) -> torch.Tensor:
    """[m, k] bool: the (token, slot) pairs that fit their expert's
    capacity, in JAX's order (token-major, then slot)."""
    flat = top_e.reshape(-1)
    onehot = F.one_hot(flat, e)
    pos = ((torch.cumsum(onehot, 0) - onehot) * onehot).sum(-1)
    return (pos < cap).reshape(top_e.shape)


def _experts(p: Params, xf: torch.Tensor, top_e: torch.Tensor,
             keep: torch.Tensor) -> torch.Tensor:
    """Each kept (token, slot) pair's expert output, [m, k, D] (zero
    where dropped): the pairs sorted by expert, each expert's swiglu on
    its own rows."""
    m, k = top_e.shape
    e = p["w_gate"].shape[0]
    # one view per expert by unbind (indexing a leaf per expert would give
    # each expert's backward a zeroed gradient of the whole stack)
    wg, wu, wd = (p[n].unbind(0) for n in ("w_gate", "w_up", "w_down"))
    out = xf.new_zeros((m * k, xf.shape[-1]))
    flat = torch.where(keep, top_e, e).reshape(-1)      # dropped -> e
    order = torch.argsort(flat, stable=True)
    counts = torch.bincount(flat, minlength=e + 1)[:e].tolist()
    rows = order // k
    start = 0
    for ex, n in enumerate(counts):
        if n:
            sel = order[start:start + n]
            xe = xf[rows[start:start + n]]
            out[sel] = (F.silu(xe @ wg[ex]) * (xe @ wu[ex])) @ wd[ex]
            start += n
    return out.reshape(m, k, -1)


def moe_forward(cfg: ModelConfig, p: Params, x: torch.Tensor,
                capacity_factor: float | None = None,
                dropless: bool = False):
    """x: [B, T, D] -> (y [B, T, D], aux_loss 0-d fp32)."""
    b, t, d = x.shape
    xf = x.reshape(b * t, d)
    top_e, top_p, aux = route(cfg, p, xf)
    if dropless:    # cap = m: a pair's place in its queue is below m
        keep = torch.ones_like(top_e, dtype=torch.bool)
    else:
        keep = keep_mask(top_e, cfg.num_experts,
                         capacity(cfg, b * t, capacity_factor))
    ye = _experts(p, xf, top_e, keep)                     # [m, k, D]
    w = (top_p * keep).to(ye.dtype)
    y = ye[:, 0] * w[:, :1]
    for j in range(1, ye.shape[1]):                       # slot order
        y = y + ye[:, j] * w[:, j:j + 1]
    if "shared" in p:
        y = y + swiglu(p["shared"], xf)
    return y.reshape(b, t, d), aux
