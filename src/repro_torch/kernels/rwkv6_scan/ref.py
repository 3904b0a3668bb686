"""Plain PyTorch version of the RWKV6 time-mix recurrence (any device):
the per-token loop of ``repro.models.rwkv6._time_mix_core`` (which equals
``repro.kernels.rwkv6_scan.ref.rwkv6_scan_ref``), in fp32."""

from __future__ import annotations

import torch


def rwkv6_scan_ref(r, k, v, w, u, s0):
    """Per-head Finch recurrence.

    r, k, v, w: [B, T, H, M]; u: [H, M]; s0: [B, H, M, M].
      y_t[j] = sum_i r[i] * (S[i, j] + u[i] k[i] v[j])
      S     <- diag(w_t) S + k_t v_t^T
    Returns (y [B, T, H, M] fp32, s_T [B, H, M, M] fp32); s0 is not
    written.
    """
    r, k, v, w = (z.float() for z in (r, k, v, w))
    u = u.float()
    s = s0.float()
    ys = []
    for t in range(r.shape[1]):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]
        att = s + u[None, :, :, None] * kv
        ys.append(torch.einsum("bhm,bhmn->bhn", r[:, t], att))
        s = w[:, t, :, :, None] * s + kv
    return torch.stack(ys, 1), s
