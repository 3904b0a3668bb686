"""Plain PyTorch version of the flash-attention prefill (any device):
fp32 logits, mask, softmax and PV product; output in q's dtype."""

from __future__ import annotations

import math

import torch


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0,
                  q_chunk: int = 1024) -> torch.Tensor:
    """q: [B, T, H, hd]; k, v: [B, S, K, hd] (GQA: H multiple of K). The
    logits are made ``q_chunk`` query rows at a time, from q scaled
    before the product, and masked and normalised in place: one fp32
    [B, K, G * q_chunk, S] buffer is alive at a time, laid out as both
    products take it (no copy), and each chunk's output goes straight
    into its rows of the output."""
    b, t, h, hd = q.shape
    s, kh = k.shape[1], k.shape[2]
    g = h // kh
    qr = q.reshape(b, t, kh, g, hd).float() / math.sqrt(hd)
    kt = k.float().permute(0, 2, 3, 1)                     # [B, K, hd, S]
    vf = v.float().permute(0, 2, 1, 3).contiguous()        # [B, K, S, hd]
    kpos = torch.arange(s, device=q.device)[None, :]
    out = qr.new_empty((b, t, kh, g, hd))
    for c0 in range(0, t, q_chunk):    # rows are independent
        qc = qr[:, c0:c0 + q_chunk]
        tc = qc.shape[1]
        lg = qc.permute(0, 2, 3, 1, 4).reshape(b, kh, g * tc, hd) @ kt
        qpos = c0 + torch.arange(tc, device=q.device)[:, None]
        mask = torch.ones((tc, s), dtype=torch.bool, device=q.device)
        if causal:
            mask &= kpos <= qpos
        if window:
            mask &= kpos > qpos - window
        lg.view(b, kh, g, tc, s).masked_fill_(~mask, -1e30)
        lg.sub_(lg.amax(-1, keepdim=True)).exp_()      # softmax in place
        lg.div_(lg.sum(-1, keepdim=True))
        out[:, c0:c0 + tc] = (lg @ vf).view(b, kh, g, tc, hd) \
            .permute(0, 3, 1, 2, 4)
        del lg
    return out.reshape(b, t, h, hd).to(q.dtype)
