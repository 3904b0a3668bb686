"""RWKV-6 "Finch" block, in PyTorch: linear attention with data-dependent
decay.

Per head (head size M): state S in R^{M x M},
    y_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)
    S_t = diag(w_t) S_{t-1} + k_t v_t^T
with w_t = exp(-exp(ddlerp_w(x_t, x_{t-1}))) data-dependent per channel,
and token-shift low-rank ("ddlerp") mixing for r/k/v/w/g. Channel-mix is
the squared-ReLU token-shift MLP.

Same parameter tree as ``repro.models.rwkv6`` (nested ``maa``,
``maa_lora`` and ``decay_lora`` dicts; dense weights ``[d_in, d_out]``).
On the serving path (``prefill``, ``decode_step``) the recurrence goes
through ``kernels.rwkv6_scan`` (the Hopper kernel for a CUDA tensor, state
updated in place); on the train path (``time_mix(...,
differentiable=True)``) through the scan's plain version, the per-token
loop of JAX's jnp ``_time_mix_core`` in fp32, under autograd.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.rwkv6_scan.ops import rwkv6_scan
from repro_torch.kernels.rwkv6_scan.ref import rwkv6_scan_ref
from repro_torch.models.layers import Params, dense, dense_params, group_norm

LORA_R = 32
MIX_NAMES = ("w", "k", "v", "r", "g")


def _lora(gen, d, out, dtype, stack: tuple = ()) -> Params:
    return {"a": dense_params(gen, d, LORA_R, dtype, stack=stack),
            "b": dense_params(gen, LORA_R, out, dtype, scale=1e-2,
                              stack=stack)}


def _lora_apply(p: Params, x: torch.Tensor) -> torch.Tensor:
    return dense(p["b"], torch.tanh(dense(p["a"], x)))


def rwkv6_params(gen: torch.Generator, cfg: ModelConfig, dtype,
                 stack: tuple = ()) -> Params:
    """``stack`` prepends leading dims (``(L,)`` for stacked blocks)."""
    d, dev = cfg.d_model, gen.device

    def full(value):
        return torch.full((*stack, d), value, dtype=dtype, device=dev)

    return {
        "maa_x": full(0.0),
        "maa": {n: full(0.0) for n in MIX_NAMES},
        "maa_lora": {n: _lora(gen, d, d, dtype, stack) for n in MIX_NAMES},
        "decay_base": full(-6.0),
        "decay_lora": _lora(gen, d, d, dtype, stack),
        "bonus_u": full(0.5),
        "wr": dense_params(gen, d, d, dtype, stack=stack),
        "wk": dense_params(gen, d, d, dtype, stack=stack),
        "wv": dense_params(gen, d, d, dtype, stack=stack),
        "wg": dense_params(gen, d, d, dtype, stack=stack),
        "wo": dense_params(gen, d, d, dtype, stack=stack),
        "ln_w": full(1.0),
        "ln_b": full(0.0),
        # channel mix
        "cm_maa_k": full(0.0),
        "cm_maa_r": full(0.0),
        "cm_wk": dense_params(gen, d, cfg.d_ff, dtype, stack=stack),
        "cm_wv": dense_params(gen, cfg.d_ff, d, dtype, stack=stack),
        "cm_wr": dense_params(gen, d, d, dtype, stack=stack),
    }


def _ddlerp(p: Params, x, x_prev) -> dict:
    """Data-dependent token-shift mixing -> dict of mixed inputs."""
    xx = x_prev - x
    base = x + xx * p["maa_x"]
    return {n: x + xx * (p["maa"][n] + _lora_apply(p["maa_lora"][n], base))
            for n in p["maa"]}


def _heads(cfg: ModelConfig, t: torch.Tensor) -> torch.Tensor:
    b, tt, d = t.shape
    m = cfg.rwkv_head_dim
    return t.reshape(b, tt, d // m, m)


def _shifted(x: torch.Tensor, x_prev0: torch.Tensor) -> torch.Tensor:
    """x_{t-1} for every t: the previous chunk's last token, then x[:-1]
    (with T = 1, the previous token alone)."""
    return torch.cat([x_prev0[:, None].to(x.dtype), x[:, :-1]], 1)


def rwkv6_state(cfg: ModelConfig, batch: int, layers: int | None = None, *,
                device: torch.device) -> dict:
    """Zeroed recurrent state {"wkv" [L,B,H,M,M], "tm_prev", "cm_prev"
    [L,B,D]}, all fp32 on ``device``."""
    n_l = cfg.num_layers if layers is None else layers
    d, m = cfg.d_model, cfg.rwkv_head_dim
    h = d // m
    f32 = dict(dtype=torch.float32, device=device)
    return {"wkv": torch.zeros((n_l, batch, h, m, m), **f32),
            "tm_prev": torch.zeros((n_l, batch, d), **f32),
            "cm_prev": torch.zeros((n_l, batch, d), **f32)}


def time_mix(cfg: ModelConfig, p: Params, x, s0, x_prev0,
             s_out: torch.Tensor | None = None, *,
             differentiable: bool = False):
    """x: [B,T,D] normed. s0: [B,H,M,M] fp32. x_prev0: [B,D] last token
    of the previous chunk (zeros at t=0). Returns (out [B,T,D], s_T,
    x_last). ``s_out`` (may be ``s0``) receives s_T in place.
    ``differentiable`` runs the recurrence as plain PyTorch that autograd
    follows (JAX's ``_time_mix_core``), not the scan kernel; it takes no
    ``s_out``."""
    if differentiable and s_out is not None:
        raise ValueError("the differentiable recurrence writes no state "
                         "in place")
    b, t, d = x.shape
    m = cfg.rwkv_head_dim
    h = d // m
    mixed = _ddlerp(p, x, _shifted(x, x_prev0))
    r = _heads(cfg, dense(p["wr"], mixed["r"]))
    k = _heads(cfg, dense(p["wk"], mixed["k"]))
    v = _heads(cfg, dense(p["wv"], mixed["v"]))
    g = F.silu(dense(p["wg"], mixed["g"]))
    decay = (p["decay_base"].float()
             + _lora_apply(p["decay_lora"], mixed["w"]).float())
    w = torch.exp(-torch.exp(decay)).reshape(b, t, h, m)
    u = p["bonus_u"].float().reshape(h, m)
    if differentiable:
        y, s_t = rwkv6_scan_ref(r, k, v, w, u, s0)
    else:
        y, s_t = rwkv6_scan(r, k, v, w, u, s0, s_out)
    y = group_norm(y.reshape(b, t, d).to(x.dtype), p["ln_w"], p["ln_b"], h,
                   cfg.norm_eps)
    out = dense(p["wo"], y * g)
    return out, s_t, x[:, -1].float()


def channel_mix(cfg: ModelConfig, p: Params, x, x_prev0):
    """Squared-relu channel mix with token shift. Returns (out, x_last)."""
    xx = _shifted(x, x_prev0) - x
    xk = x + xx * p["cm_maa_k"]
    xr = x + xx * p["cm_maa_r"]
    kk = torch.square(torch.relu(dense(p["cm_wk"], xk)))
    return (torch.sigmoid(dense(p["cm_wr"], xr)) * dense(p["cm_wv"], kk),
            x[:, -1].float())
