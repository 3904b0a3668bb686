"""Plain PyTorch version of the flash-attention prefill (any device):
fp32 logits, mask, softmax and PV product; output in q's dtype."""

from __future__ import annotations

import math

import torch


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0) -> torch.Tensor:
    """q: [B, T, H, hd]; k, v: [B, S, K, hd] (GQA: H multiple of K)."""
    b, t, h, hd = q.shape
    s, kh = k.shape[1], k.shape[2]
    g = h // kh
    qr = q.reshape(b, t, kh, g, hd).float()
    lg = torch.einsum("btkgh,bskh->bkgts", qr, k.float()) / math.sqrt(hd)
    qpos = torch.arange(t, device=q.device)[:, None]
    kpos = torch.arange(s, device=q.device)[None, :]
    mask = torch.ones((t, s), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window:
        mask &= kpos > qpos - window
    lg = lg.masked_fill(~mask[None, None, None], -1e30)
    w = torch.softmax(lg, -1)
    out = torch.einsum("bkgts,bskh->btkgh", w, v.float())
    return out.reshape(b, t, h, hd).to(q.dtype)
