"""Plain PyTorch version of single-token GQA decode attention (any
device): fp32 logits, the ``kv_len`` mask, softmax and PV product, as
``repro.kernels.decode_attention.ref`` computes them; output in q's
dtype."""

from __future__ import annotations

import math

import torch


def decode_attention_ref(q: torch.Tensor, k_cache: torch.Tensor,
                         v_cache: torch.Tensor,
                         kv_len: torch.Tensor) -> torch.Tensor:
    """q: [B, H, hd] (one token); caches: [B, S, K, hd]; kv_len: [B] valid
    slots per sequence. Returns [B, H, hd]."""
    b, h, hd = q.shape
    s, kh = k_cache.shape[1], k_cache.shape[2]
    g = h // kh
    qr = q.reshape(b, kh, g, hd).float()
    lg = torch.einsum("bkgh,bskh->bkgs", qr, k_cache.float()) / math.sqrt(hd)
    valid = (torch.arange(s, device=q.device)[None, :]
             < kv_len.to(q.device)[:, None])                   # [B, S]
    lg = lg.masked_fill(~valid[:, None, None, :], -1e30)
    w = torch.softmax(lg, -1)
    out = torch.einsum("bkgs,bskh->bkgh", w, v_cache.float())
    return out.reshape(b, h, hd).to(q.dtype)
