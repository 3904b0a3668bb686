"""The remote tier's model API, in PyTorch — dense attention and RWKV6.

Plain functions over the JAX package's parameter tree:

    init_params(cfg, gen)                        -> params
    forward(cfg, params, batch)                  -> (final hidden [B,T,D], aux)
    prefill(cfg, params, batch)                  -> (last-position logits, cache)
    make_cache(cfg, batch, max_len, device)      -> zeroed serving cache
    decode_step(cfg, params, token, cache, pos)  -> (logits [B,V], cache)

Layer weights are stacked ``[L, ...]`` as in ``repro.models.transformer``;
where JAX scans over the stack, the port loops over ``l`` and indexes the
stacked tensors (views — the weights are never copied into per-layer
modules). ``decode_step`` writes the new token's keys and values into the
cache in place (JAX returns a new cache; the port returns the same one).

RWKV6 (``block_type == "rwkv6"``) keeps the recurrent state
``{"rwkv": {"wkv" [L,B,H,M,M], "tm_prev", "cm_prev" [L,B,D]}}`` (fp32) of
``repro.models.rwkv6.rwkv6_state`` as its cache. ``prefill`` runs the
stack from a zeroed state and returns it; ``decode_step`` runs the same
stack on one token (the token shift then concatenates the stored previous
token with an empty ``x[:, :-1]``, as JAX does) and updates the state in
place, layer by layer. The moe, mla, mamba2 and frontend families, and
``decode_step`` on ``[B, D]`` embeddings, come with later slices of the
port.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import rwkv6 as rwkv
from repro_torch.models.layers import (Params, attention_params, attn_decode,
                                       attn_forward, attn_prefill, dense,
                                       decode_inputs, dense_params,
                                       make_kv_cache, normal, rms_norm,
                                       swiglu, swiglu_params)
from repro_torch.tree import tree_map

Batch = dict[str, Any]

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "float16": torch.float16}


def _check_family(cfg: ModelConfig) -> None:
    if (cfg.block_type not in ("attn", "rwkv6") or cfg.use_mla
            or cfg.is_moe or cfg.takes_embeddings):
        raise NotImplementedError(
            f"{cfg.name}: only the dense attention and rwkv6 families are "
            f"ported; moe, mla, mamba2 and frontend models come with a "
            f"later slice")


def _is_rwkv(cfg: ModelConfig) -> bool:
    return cfg.block_type == "rwkv6"


def init_params(cfg: ModelConfig, gen: torch.Generator) -> Params:
    """Random parameters drawn directly on ``gen.device`` in the config's
    dtype (a full-width bf16 model never needs an fp32 copy)."""
    _check_family(cfg)
    dtype, dev = DTYPES[cfg.dtype], gen.device
    n = cfg.num_layers
    d = cfg.d_model
    out_dim = cfg.num_classes or cfg.vocab_size
    blocks = {"norm1": torch.ones((n, d), dtype=dtype, device=dev),
              "norm2": torch.ones((n, d), dtype=dtype, device=dev)}
    if _is_rwkv(cfg):
        blocks.update(rwkv.rwkv6_params(gen, cfg, dtype, stack=(n,)))
    else:
        blocks["attn"] = attention_params(gen, cfg, dtype, stack=(n,))
        blocks["mlp"] = swiglu_params(gen, d, cfg.d_ff, dtype, stack=(n,))
    return {
        "embed": normal(gen, (cfg.vocab_size, d), dtype, 0.02),
        "final_norm": torch.ones(d, dtype=dtype, device=dev),
        "head": dense_params(gen, d, out_dim, dtype),
        "blocks": blocks,
    }


def _layer(blocks: Params, i: int) -> Params:
    return tree_map(lambda a: a[i], blocks)


def _num_layers(params: Params) -> int:
    return params["blocks"]["norm1"].shape[0]


def _embed_in(params: Params, batch: Batch) -> torch.Tensor:
    tokens = torch.as_tensor(batch["tokens"],
                             device=params["embed"].device).long()
    return params["embed"][tokens]


def _rwkv_body(cfg: ModelConfig, lp: Params, x, st: Params):
    """st: one layer's views {"wkv", "tm_prev", "cm_prev"} of the stacked
    state, updated in place; returns x."""
    h = rms_norm(x, lp["norm1"], cfg.norm_eps)
    out, _, tm_last = rwkv.time_mix(cfg, lp, h, st["wkv"], st["tm_prev"],
                                    s_out=st["wkv"])
    st["tm_prev"].copy_(tm_last)
    x = x + out
    h = rms_norm(x, lp["norm2"], cfg.norm_eps)
    out, cm_last = rwkv.channel_mix(cfg, lp, h, st["cm_prev"])
    st["cm_prev"].copy_(cm_last)
    return x + out


def _run_rwkv_stack(cfg: ModelConfig, params: Params, x, state: Params):
    """state: stacked [L, ...] rwkv6 state, updated in place layer by
    layer. Returns (x, state)."""
    for i in range(_num_layers(params)):
        x = _rwkv_body(cfg, _layer(params["blocks"], i), x,
                       _layer(state, i))
    return x, state


def forward(cfg: ModelConfig, params: Params, batch: Batch):
    """Full-sequence hidden states [B,T,D] (+ aux dict)."""
    _check_family(cfg)
    x = _embed_in(params, batch)
    if _is_rwkv(cfg):
        x, _ = _run_rwkv_stack(cfg, params, x, rwkv.rwkv6_state(
            cfg, x.shape[0], _num_layers(params), device=x.device))
    else:
        positions = torch.arange(x.shape[1], device=x.device)
        causal = not cfg.is_encoder
        for i in range(_num_layers(params)):
            lp = _layer(params["blocks"], i)
            h = rms_norm(x, lp["norm1"], cfg.norm_eps)
            x = x + attn_forward(cfg, lp["attn"], h, positions,
                                 causal=causal)
            h = rms_norm(x, lp["norm2"], cfg.norm_eps)
            x = x + swiglu(lp["mlp"], h)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x, {"moe_aux": torch.zeros((), device=x.device)}


def _head_logits(params: Params, x_last):
    """x_last: [B, D] -> logits [B, V or C] fp32."""
    return dense(params["head"], x_last).float()


def prefill(cfg: ModelConfig, params: Params, batch: Batch):
    """Run the full prompt; return (last-position logits [B, V] fp32,
    cache {"main": {"k", "v": [L, B, T, K, hd]}}, or {"rwkv": state} for
    RWKV6)."""
    _check_family(cfg)
    x = _embed_in(params, batch)
    if _is_rwkv(cfg):
        x, state = _run_rwkv_stack(cfg, params, x, rwkv.rwkv6_state(
            cfg, x.shape[0], _num_layers(params), device=x.device))
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        return _head_logits(params, x[:, -1]), {"rwkv": state}
    positions = torch.arange(x.shape[1], device=x.device)
    ks, vs = [], []
    for i in range(_num_layers(params)):
        lp = _layer(params["blocks"], i)
        h = rms_norm(x, lp["norm1"], cfg.norm_eps)
        a, (k, v) = attn_prefill(cfg, lp["attn"], h, positions)
        ks.append(k)
        vs.append(v)
        x = x + a
        h = rms_norm(x, lp["norm2"], cfg.norm_eps)
        x = x + swiglu(lp["mlp"], h)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    cache = {"main": {"k": torch.stack(ks), "v": torch.stack(vs)}}
    return _head_logits(params, x[:, -1]), cache


def make_cache(cfg: ModelConfig, batch: int, max_len: int,
               device: str | torch.device = "cuda"):
    """Zeroed serving cache {"main": {"k", "v": [L, B, slots, K, hd]}} in
    the config's dtype (``slots = min(max_len, window)`` under SWA); for
    RWKV6 the zeroed fp32 recurrent state {"rwkv": ...}, whatever
    ``max_len``."""
    _check_family(cfg)
    if _is_rwkv(cfg):
        return {"rwkv": rwkv.rwkv6_state(cfg, batch,
                                         device=resolve_device(device))}
    return {"main": make_kv_cache(cfg, batch, max_len, DTYPES[cfg.dtype],
                                  device=resolve_device(device))}


def decode_step(cfg: ModelConfig, params: Params, token, cache, pos: int):
    """One new token. token: [B] int (on the params' device, or host
    ints); pos: absolute position of the token. Writes its keys and values
    (RWKV6: the new recurrent state) into ``cache`` in place; returns
    (logits [B, V] fp32, cache)."""
    _check_family(cfg)
    if not cfg.supports_decode:
        raise ValueError(f"{cfg.name} is encoder-only")
    token = torch.as_tensor(token, device=params["embed"].device)
    if token.dim() != 1:
        raise NotImplementedError("decode_step on [B, D] embeddings comes "
                                  "with the frontend families")
    x = params["embed"][token.long()][:, None, :]
    if _is_rwkv(cfg):
        x, _ = _run_rwkv_stack(cfg, params, x, cache["rwkv"])
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        return _head_logits(params, x[:, 0]), cache
    kc, vc = cache["main"]["k"], cache["main"]["v"]
    positions, kv_len = decode_inputs(cfg, pos, x.shape[0], kc.shape[2],
                                      kc.device)
    for i in range(_num_layers(params)):
        lp = _layer(params["blocks"], i)
        h = rms_norm(x, lp["norm1"], cfg.norm_eps)
        a, _, _ = attn_decode(cfg, lp["attn"], h, kc[i], vc[i], pos,
                              positions, kv_len)
        x = x + a
        h = rms_norm(x, lp["norm2"], cfg.norm_eps)
        x = x + swiglu(lp["mlp"], h)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return _head_logits(params, x[:, 0]), cache
