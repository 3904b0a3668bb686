"""Mamba2 (SSD) mixer, in PyTorch — the backbone block of Zamba2.

Scalar-decay state-space duality form, per head (head dim P, state N):
    h_t = exp(dt_t * a) * h_{t-1} + dt_t * x_t B_t^T     (h in R^{P x N})
    y_t = h_t C_t + D * x_t
with a < 0 learned per head, dt_t = softplus(dt_proj(u_t) + dt_bias) per
head, B_t, C_t in R^N shared across the head's channels, a depthwise
causal conv (width 4) on x and on (B, C), and a SiLU gate z. The state
is O(1) in the sequence length.

Same parameter tree and numerics as ``repro.models.mamba2``: the
in-projections unfused by role (``w_zx``, ``w_bc``, ``w_dt``); the
``d_inner`` channel axis flattened P-major (index ``p * h + head``), so
``w_zx``, the conv weights, ``out_norm`` and ``w_out`` carried over from
JAX line up; the conv state cast to the input's dtype and its four taps
summed in that dtype, in tap order, its new state returned in fp32; dt,
the decay, the SSM state [B, H, P, N] and y in fp32. JAX runs the
recurrence with ``lax.scan`` and no Pallas kernel; the port runs it as a
per-token loop in plain PyTorch (differentiable: the train path runs the
same function under autograd).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import (Params, dense, dense_params, normal,
                                       rms_norm)

CONV_W = 4
HEAD_P = 64  # mamba2 head dim


def dims(cfg: ModelConfig) -> tuple[int, int, int]:
    """(d_inner, heads, state dim N)."""
    d_inner = 2 * cfg.d_model
    return d_inner, d_inner // HEAD_P, cfg.ssm_state_dim


def mamba2_params(gen: torch.Generator, cfg: ModelConfig, dtype,
                  stack: tuple = ()) -> Params:
    """``stack`` prepends leading dims (``(L,)`` for stacked blocks); the
    per-head ``a_log``, ``dt_bias`` and ``d_skip`` are fp32, as in
    JAX."""
    d, dev = cfg.d_model, gen.device
    d_inner, h, n = dims(cfg)
    a_log = torch.log(torch.linspace(1.0, 16.0, h, device=dev))
    return {
        "w_zx": dense_params(gen, d, 2 * d_inner, dtype, stack=stack),
        "w_bc": dense_params(gen, d, 2 * n, dtype, stack=stack),
        "w_dt": dense_params(gen, d, h, dtype, stack=stack),
        "conv_x_w": normal(gen, (*stack, CONV_W, d_inner), dtype, 0.1),
        "conv_x_b": torch.zeros((*stack, d_inner), dtype=dtype, device=dev),
        "conv_bc_w": normal(gen, (*stack, CONV_W, 2 * n), dtype, 0.1),
        "conv_bc_b": torch.zeros((*stack, 2 * n), dtype=dtype, device=dev),
        "a_log": a_log.expand(*stack, h).clone(),
        "dt_bias": torch.zeros((*stack, h), device=dev),
        "d_skip": torch.ones((*stack, h), device=dev),
        "out_norm": torch.ones((*stack, d_inner), dtype=dtype, device=dev),
        "w_out": dense_params(gen, d_inner, d, dtype, stack=stack),
    }


def mamba2_state(cfg: ModelConfig, batch: int, layers: int | None = None,
                 device: torch.device | None = None) -> Params:
    """Zeroed fp32 state {"ssm" [L, B, H, P, N], "conv_x" [L, B, 3,
    d_inner], "conv_bc" [L, B, 3, 2N]} (``layers`` defaults to the
    config's)."""
    n_l = cfg.num_layers if layers is None else layers
    d_inner, h, n = dims(cfg)

    def zeros(*shape):
        return torch.zeros((n_l, batch, *shape), device=device)

    return {"ssm": zeros(h, HEAD_P, n), "conv_x": zeros(CONV_W - 1, d_inner),
            "conv_bc": zeros(CONV_W - 1, 2 * n)}


def _conv(w, b, xbc, conv_state):
    """Depthwise causal conv of width 4. xbc: [B, T, C]; conv_state:
    [B, 3, C] fp32. Returns (silu(conv + b), the new state in fp32)."""
    t = xbc.shape[1]
    x_pad = torch.cat([conv_state.to(xbc.dtype), xbc], 1)
    out = x_pad[:, :t] * w[0]
    for i in range(1, CONV_W):
        out = out + x_pad[:, i:i + t] * w[i]
    return F.silu(out + b), x_pad[:, -(CONV_W - 1):].float()


def mamba2_forward(cfg: ModelConfig, p: Params, x: torch.Tensor,
                   state: Params | None = None):
    """Full-sequence SSD mixer. x: [B, T, D] -> (y [B, T, D], final state
    {"ssm" [B, H, P, N], "conv_x", "conv_bc"}). ``state``: the initial
    state of that form (one layer's), zeros if None (a fresh sequence);
    it is read, never written."""
    b, t, _ = x.shape
    d_inner, h, n = dims(cfg)
    zx = dense(p["w_zx"], x)
    z, xi = zx[..., :d_inner], zx[..., d_inner:]
    bc = dense(p["w_bc"], x)
    dt = dense(p["w_dt"], x)
    if state is None:
        state = {"ssm": x.new_zeros((b, h, HEAD_P, n), dtype=torch.float32),
                 "conv_x": x.new_zeros((b, CONV_W - 1, d_inner),
                                       dtype=torch.float32),
                 "conv_bc": x.new_zeros((b, CONV_W - 1, 2 * n),
                                        dtype=torch.float32)}
    xi, conv_x = _conv(p["conv_x_w"], p["conv_x_b"], xi, state["conv_x"])
    bc, conv_bc = _conv(p["conv_bc_w"], p["conv_bc_b"], bc, state["conv_bc"])
    bb, cc = bc[..., :n].float(), bc[..., n:].float()

    dt = F.softplus(dt.float() + p["dt_bias"])                # [B, T, H]
    decay = torch.exp(dt * -torch.exp(p["a_log"]))            # [B, T, H]
    # d_inner is flattened P-major (index = p * h + head)
    x_h = xi.float().reshape(b, t, HEAD_P, h).transpose(2, 3)  # [B,T,H,P]
    dtx = dt[..., None] * x_h                                 # [B,T,H,P]
    s = state["ssm"].float()
    ys = []
    for i in range(t):
        upd = dtx[:, i, :, :, None] * bb[:, i, None, None, :]  # [B,H,P,N]
        s = decay[:, i, :, None, None] * s + upd
        ys.append(torch.einsum("bhpn,bn->bhp", s, cc[:, i]))
    y = torch.stack(ys, 1) + p["d_skip"][:, None] * x_h
    y = y.transpose(2, 3).reshape(b, t, d_inner).to(x.dtype)
    y = rms_norm(y * F.silu(z), p["out_norm"], cfg.norm_eps)
    return dense(p["w_out"], y), {"ssm": s, "conv_x": conv_x,
                                  "conv_bc": conv_bc}


def mamba2_decode(cfg: ModelConfig, p: Params, x: torch.Tensor,
                  state: Params):
    """One-token step. x: [B, 1, D]; state {"ssm" [B, H, P, N], "conv_x",
    "conv_bc"}: ``mamba2_forward`` from that state."""
    return mamba2_forward(cfg, p, x, state=state)

