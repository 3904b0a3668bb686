"""The remote tier's model API, in PyTorch — dense attention family.

Plain functions over the JAX package's parameter tree:

    init_params(cfg, gen)          -> params
    forward(cfg, params, batch)    -> (final hidden [B,T,D], aux)
    prefill(cfg, params, batch)    -> (last-position logits, cache)

Layer weights are stacked ``[L, ...]`` as in ``repro.models.transformer``;
where JAX scans over the stack, the port loops over ``l`` and indexes the
stacked tensors (views — the weights are never copied into per-layer
modules). ``decode_step``/``make_cache`` and the moe, mla, mamba2, rwkv6
and frontend families come with later slices of the port.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import (Params, attention_params, attn_forward,
                                       attn_prefill, dense, dense_params,
                                       normal, rms_norm, swiglu,
                                       swiglu_params)
from repro_torch.tree import tree_map

Batch = dict[str, Any]

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "float16": torch.float16}


def _check_family(cfg: ModelConfig) -> None:
    if (cfg.block_type != "attn" or cfg.use_mla or cfg.is_moe
            or cfg.takes_embeddings):
        raise NotImplementedError(
            f"{cfg.name}: only the dense attention family is ported; moe, "
            f"mla, mamba2, rwkv6 and frontend models come with a later "
            f"slice")


def init_params(cfg: ModelConfig, gen: torch.Generator) -> Params:
    """Random parameters drawn directly on ``gen.device`` in the config's
    dtype (a full-width bf16 model never needs an fp32 copy)."""
    _check_family(cfg)
    dtype, dev = DTYPES[cfg.dtype], gen.device
    n = cfg.num_layers
    d = cfg.d_model
    out_dim = cfg.num_classes or cfg.vocab_size
    return {
        "embed": normal(gen, (cfg.vocab_size, d), dtype, 0.02),
        "final_norm": torch.ones(d, dtype=dtype, device=dev),
        "head": dense_params(gen, d, out_dim, dtype),
        "blocks": {
            "norm1": torch.ones((n, d), dtype=dtype, device=dev),
            "norm2": torch.ones((n, d), dtype=dtype, device=dev),
            "attn": attention_params(gen, cfg, dtype, stack=(n,)),
            "mlp": swiglu_params(gen, d, cfg.d_ff, dtype, stack=(n,)),
        },
    }


def _layer(blocks: Params, i: int) -> Params:
    return tree_map(lambda a: a[i], blocks)


def _num_layers(params: Params) -> int:
    return params["blocks"]["norm1"].shape[0]


def _embed_in(params: Params, batch: Batch) -> torch.Tensor:
    tokens = torch.as_tensor(batch["tokens"],
                             device=params["embed"].device).long()
    return params["embed"][tokens]


def forward(cfg: ModelConfig, params: Params, batch: Batch):
    """Full-sequence hidden states [B,T,D] (+ aux dict)."""
    _check_family(cfg)
    x = _embed_in(params, batch)
    positions = torch.arange(x.shape[1], device=x.device)
    causal = not cfg.is_encoder
    for i in range(_num_layers(params)):
        lp = _layer(params["blocks"], i)
        h = rms_norm(x, lp["norm1"], cfg.norm_eps)
        x = x + attn_forward(cfg, lp["attn"], h, positions, causal=causal)
        h = rms_norm(x, lp["norm2"], cfg.norm_eps)
        x = x + swiglu(lp["mlp"], h)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x, {"moe_aux": torch.zeros((), device=x.device)}


def _head_logits(params: Params, x_last):
    """x_last: [B, D] -> logits [B, V or C] fp32."""
    return dense(params["head"], x_last).float()


def prefill(cfg: ModelConfig, params: Params, batch: Batch):
    """Run the full prompt; return (last-position logits [B, V] fp32,
    cache {"main": {"k", "v": [L, B, T, K, hd]}})."""
    _check_family(cfg)
    x = _embed_in(params, batch)
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
