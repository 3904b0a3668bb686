"""Plain PyTorch version of the flash-attention prefill (any device):
fp32 logits, mask, softmax and PV product; output in q's dtype."""

from __future__ import annotations

import math

import torch


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0,
                  q_chunk: int = 1024) -> torch.Tensor:
    """q: [B, T, H, hd]; k, v: [B, S, K, hd] (GQA: H multiple of K). The
    logits are made ``q_chunk`` query rows at a time."""
    b, t, h, hd = q.shape
    s, kh = k.shape[1], k.shape[2]
    g = h // kh
    qr = q.reshape(b, t, kh, g, hd).float()
    kf, vf = k.float(), v.float()
    kpos = torch.arange(s, device=q.device)[None, :]
    outs = []
    for c0 in range(0, t, q_chunk):    # rows are independent
        qc = qr[:, c0:c0 + q_chunk]
        lg = torch.einsum("btkgh,bskh->bkgts", qc, kf) / math.sqrt(hd)
        qpos = c0 + torch.arange(qc.shape[1], device=q.device)[:, None]
        mask = torch.ones((qc.shape[1], s), dtype=torch.bool,
                          device=q.device)
        if causal:
            mask &= kpos <= qpos
        if window:
            mask &= kpos > qpos - window
        lg = lg.masked_fill(~mask[None, None, None], -1e30)
        w = torch.softmax(lg, -1)
        outs.append(torch.einsum("bkgts,bskh->btkgh", w, vf))
    out = torch.cat(outs, 1)
    return out.reshape(b, t, h, hd).to(q.dtype)
