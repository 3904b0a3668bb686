"""Shared transformer building blocks, in PyTorch.

Plain functions over dict parameter trees in the JAX package's layout:
dense weights are ``[d_in, d_out]`` with ``y = x @ w + b`` (not the
``nn.Linear`` orientation), so a tree carried over by
``repro_torch.weights.params_from_jax`` drops in unchanged.

Numerics follow ``repro.models.layers``: norms compute in fp32 and cast
back; rope rotates the two HALVES of the head dim (not interleaved
pairs); the plain ``gqa_attention`` keeps logits and softmax in fp32 even
for bf16 inputs (JAX's ``preferred_element_type=f32``), rounds the
probabilities to the value dtype before the PV product, and accumulates
that product in fp32. Full-sequence attention in ``attn_forward`` /
``attn_prefill`` goes through ``kernels.flash_attention`` (the Hopper
kernel for a CUDA tensor).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention.ops import attention

Params = dict


# --------------------------------------------------------------------------
# initialisation helpers (drawn on the generator's device, in the target
# dtype: a full-width bf16 model never needs an fp32 host copy)
# --------------------------------------------------------------------------

def normal(gen: torch.Generator, shape, dtype, scale: float) -> torch.Tensor:
    return torch.randn(shape, generator=gen, device=gen.device,
                       dtype=dtype).mul_(scale)


def _dense_init(gen, shape, dtype, scale: float | None = None):
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    return normal(gen, shape, dtype, scale)


def dense_params(gen: torch.Generator, d_in: int, d_out: int, dtype,
                 bias: bool = False, scale: float | None = None,
                 stack: tuple = ()) -> Params:
    """``stack`` prepends leading dims (``(L,)`` for stacked blocks)."""
    p = {"w": _dense_init(gen, (*stack, d_in, d_out), dtype, scale)}
    if bias:
        p["b"] = torch.zeros((*stack, d_out), dtype=dtype, device=gen.device)
    return p


def dense(p: Params, x: torch.Tensor) -> torch.Tensor:
    y = x @ p["w"]
    if "b" in p:
        y = y + p["b"]
    return y


# --------------------------------------------------------------------------
# norms
# --------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, -1, keepdim=True) + eps)
    return (x * w.float()).to(dt)


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               eps: float) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, -1, keepdim=True)
    var = torch.mean(torch.square(x - mu), -1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * w.float() + b.float()).to(dt)


# --------------------------------------------------------------------------
# rotary embeddings
# --------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float,
               device: torch.device | None = None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [..., T, H, hd]; positions: broadcastable to [..., T]."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                 # [hd/2]
    angles = positions[..., None].float() * freqs           # [..., T, hd/2]
    angles = angles[..., None, :]                           # [..., T, 1, hd/2]
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# attention (GQA, optional sliding window / bias)
# --------------------------------------------------------------------------

def attention_params(gen, cfg: ModelConfig, dtype, stack: tuple = ()) -> Params:
    hd = cfg.resolved_head_dim
    return {
        "wq": dense_params(gen, cfg.d_model, cfg.num_heads * hd, dtype,
                           bias=cfg.attn_bias, stack=stack),
        "wk": dense_params(gen, cfg.d_model, cfg.num_kv_heads * hd, dtype,
                           bias=cfg.attn_bias, stack=stack),
        "wv": dense_params(gen, cfg.d_model, cfg.num_kv_heads * hd, dtype,
                           bias=cfg.attn_bias, stack=stack),
        "wo": dense_params(gen, cfg.num_heads * hd, cfg.d_model, dtype,
                           stack=stack),
    }


def _sdpa(q, k, v, mask, scale):
    """q:[B,Tq,K,G,hd] k,v:[B,S,K,hd] mask:[Tq,S] bool -> [B,Tq,K,G,hd]."""
    logits = torch.einsum("btkgh,bskh->bkgts", q.float(), k.float()) * scale
    logits = torch.where(mask[None, None, None], logits,
                         torch.tensor(-1e30, device=logits.device))
    w = torch.softmax(logits, -1)
    out = torch.einsum("bkgts,bskh->btkgh", w.to(v.dtype).float(), v.float())
    return out.to(q.dtype)


def gqa_attention(q, k, v, *, causal: bool, q_offset: int = 0,
                  window: int = 0, kv_len_valid=None, q_chunk: int = 1024):
    """Plain grouped-query attention, in query chunks of ``q_chunk`` rows.

    q: [B, Tq, H, hd]; k, v: [B, S, K, hd]. q_offset: absolute position of
    q[0]. kv_len_valid: number of valid cache slots (decode).
    """
    b, tq, h, hd = q.shape
    s, kh = k.shape[1], k.shape[2]
    g = h // kh
    q = q.reshape(b, tq, kh, g, hd)
    scale = 1.0 / math.sqrt(hd)
    kv_pos = torch.arange(s, device=q.device)

    def mask_for(q_pos):
        m = torch.ones((q_pos.shape[0], s), dtype=torch.bool, device=q.device)
        if causal:
            m &= kv_pos[None, :] <= q_pos[:, None]
        if window:
            m &= kv_pos[None, :] > q_pos[:, None] - window
        if kv_len_valid is not None:
            m &= kv_pos[None, :] < kv_len_valid
        return m

    outs = []
    for c0 in range(0, tq, q_chunk):
        qc = q[:, c0:c0 + q_chunk]
        q_pos = q_offset + c0 + torch.arange(qc.shape[1], device=q.device)
        outs.append(_sdpa(qc, k, v, mask_for(q_pos), scale))
    return torch.cat(outs, dim=1).reshape(b, tq, h, hd)


def _qkv(cfg: ModelConfig, p: Params, x, positions):
    b, t, _ = x.shape
    hd = cfg.resolved_head_dim
    q = dense(p["wq"], x).reshape(b, t, cfg.num_heads, hd)
    k = dense(p["wk"], x).reshape(b, t, cfg.num_kv_heads, hd)
    v = dense(p["wv"], x).reshape(b, t, cfg.num_kv_heads, hd)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def attn_forward(cfg: ModelConfig, p: Params, x: torch.Tensor,
                 positions: torch.Tensor, *, causal: bool) -> torch.Tensor:
    """Full-sequence attention (train / prefill / encoder)."""
    b, t, _ = x.shape
    q, k, v = _qkv(cfg, p, x, positions)
    out = attention(q, k, v, causal=causal, window=cfg.sliding_window)
    return dense(p["wo"], out.reshape(b, t, -1))


def attn_prefill(cfg: ModelConfig, p: Params, x, positions):
    """Returns (out, (k, v)) — caller stores k/v into the layer cache."""
    b, t, _ = x.shape
    q, k, v = _qkv(cfg, p, x, positions)
    out = attention(q, k, v, causal=True, window=cfg.sliding_window)
    out = dense(p["wo"], out.reshape(b, t, -1))
    if cfg.sliding_window and t > cfg.sliding_window:
        # keep only the window, rolled so position p lands at ring slot
        # p % window (the decode-side convention)
        w = cfg.sliding_window
        k = torch.roll(k[:, -w:], shifts=t % w, dims=1)
        v = torch.roll(v[:, -w:], shifts=t % w, dims=1)
    return out, (k, v)


# --------------------------------------------------------------------------
# MLPs
# --------------------------------------------------------------------------

def swiglu_params(gen, d_model: int, d_ff: int, dtype,
                  stack: tuple = ()) -> Params:
    return {
        "w_gate": dense_params(gen, d_model, d_ff, dtype, stack=stack),
        "w_up": dense_params(gen, d_model, d_ff, dtype, stack=stack),
        "w_down": dense_params(gen, d_ff, d_model, dtype, stack=stack),
    }


def swiglu(p: Params, x: torch.Tensor) -> torch.Tensor:
    return dense(p["w_down"],
                 F.silu(dense(p["w_gate"], x)) * dense(p["w_up"], x))


def gelu_mlp_params(gen, d_model: int, d_ff: int, dtype) -> Params:
    return {"w_in": dense_params(gen, d_model, d_ff, dtype, bias=True),
            "w_out": dense_params(gen, d_ff, d_model, dtype, bias=True)}


def gelu_mlp(p: Params, x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation
    return dense(p["w_out"], F.gelu(dense(p["w_in"], x), approximate="tanh"))
