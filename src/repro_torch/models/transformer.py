"""The remote tier's model API, in PyTorch — dense attention and RWKV6.

Plain functions over the JAX package's parameter tree:

    init_params(cfg, gen)                        -> params
    forward(cfg, params, batch, remat=False)     -> (final hidden [B,T,D], aux)
    loss_fn(cfg, params, batch, remat=True)      -> (loss, metrics)
    prefill(cfg, params, batch)                  -> (last-position logits, cache)
    make_cache(cfg, batch, max_len, device)      -> zeroed serving cache
    decode_step(cfg, params, token, cache, pos)  -> (logits [B,V], cache)

Layer weights are stacked ``[L, ...]`` as in ``repro.models.transformer``;
where JAX scans over the stack, the port loops over per-layer views of the
stacked tensors, made by one ``unbind`` per leaf (``tree.unstack``; the
weights are never copied into per-layer modules). ``params["blocks"]``
may also be given as that list of per-layer trees: the train step does
so, to collect each layer's gradient on its own.

``forward`` and ``loss_fn`` are the train path: functional, differentiable
and free of kernels — attention through the plain ``gqa_attention`` and
the RWKV6 recurrence through its plain loop, as JAX computes them, with
``remat`` checkpointing each layer (``torch.utils.checkpoint``, where JAX
uses ``jax.checkpoint``). Cross-entropy goes in sequence chunks, each
checkpointed, so the [B, T, V] logits live for one chunk at a time.

``prefill`` and ``decode_step`` are the serving path, through the Hopper
kernels on a CUDA tensor (call them under ``torch.no_grad()``: the kernels
have no backward). ``decode_step`` writes the new token's keys and values
into the cache in place (JAX returns a new cache; the port returns the
same one).

RWKV6 (``block_type == "rwkv6"``) keeps the recurrent state
``{"rwkv": {"wkv" [L,B,H,M,M], "tm_prev", "cm_prev" [L,B,D]}}`` (fp32) of
``repro.models.rwkv6.rwkv6_state`` as its cache. ``prefill`` runs the
stack from a zeroed state and returns it; ``decode_step`` runs the same
stack on one token (the token shift then concatenates the stored previous
token with an empty ``x[:, :-1]``, as JAX does) and updates the state in
place, layer by layer; ``forward`` runs it from a zero state without
keeping one. The moe, mla, mamba2 and frontend families (with the VLM
branch of ``loss_fn``), and ``decode_step`` on ``[B, D]`` embeddings, come
with later slices of the port.
"""

from __future__ import annotations

from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import rwkv6 as rwkv
from repro_torch.models.layers import (Params, attention_params, attn_decode,
                                       attn_forward, attn_prefill, dense,
                                       decode_inputs, dense_params,
                                       make_kv_cache, normal, rms_norm,
                                       swiglu, swiglu_params)
from repro_torch.tree import unstack

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


def _num_layers(params: Params) -> int:
    return params["blocks"]["norm1"].shape[0]


def _embed_in(params: Params, batch: Batch) -> torch.Tensor:
    if "embeds" in batch:
        raise NotImplementedError("embedding inputs come with the frontend "
                                  "families")
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
    for lp, st in zip(unstack(params["blocks"]), unstack(state)):
        x = _rwkv_body(cfg, lp, x, st)
    return x, state


def _rwkv_train_body(cfg: ModelConfig, lp: Params, x):
    """One RWKV6 block from a zero state, functional and differentiable
    (JAX's ``_rwkv_body`` in ``forward``); the state it ends in is
    dropped."""
    b, _, d = x.shape
    m = cfg.rwkv_head_dim
    prev = x.new_zeros((b, d), dtype=torch.float32)
    s0 = x.new_zeros((b, d // m, m, m), dtype=torch.float32)
    h = rms_norm(x, lp["norm1"], cfg.norm_eps)
    out, _, _ = rwkv.time_mix(cfg, lp, h, s0, prev, differentiable=True)
    x = x + out
    h = rms_norm(x, lp["norm2"], cfg.norm_eps)
    out, _ = rwkv.channel_mix(cfg, lp, h, prev)
    return x + out


def _attn_body(cfg: ModelConfig, lp: Params, x, positions, causal: bool):
    h = rms_norm(x, lp["norm1"], cfg.norm_eps)
    x = x + attn_forward(cfg, lp["attn"], h, positions, causal=causal)
    h = rms_norm(x, lp["norm2"], cfg.norm_eps)
    return x + swiglu(lp["mlp"], h)


def forward(cfg: ModelConfig, params: Params, batch: Batch, *,
            remat: bool = False):
    """Full-sequence hidden states [B,T,D] (+ aux dict), differentiable.
    ``remat`` recomputes each layer in the backward pass (a per-layer
    ``torch.utils.checkpoint``) instead of keeping its activations."""
    _check_family(cfg)
    x = _embed_in(params, batch)
    if _is_rwkv(cfg):
        def body(lp, x):
            return _rwkv_train_body(cfg, lp, x)
    else:
        positions = torch.arange(x.shape[1], device=x.device)

        def body(lp, x):
            return _attn_body(cfg, lp, x, positions, not cfg.is_encoder)
    for lp in unstack(params["blocks"]):
        if remat:
            x = checkpoint(body, lp, x, use_reentrant=False,
                           preserve_rng_state=False)
        else:
            x = body(lp, x)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x, {"moe_aux": torch.zeros((), device=x.device)}


# --------------------------------------------------------------------------
# loss (chunked cross-entropy: the [B,T,V] logits live one chunk at a time)
# --------------------------------------------------------------------------

def _ce_chunk(head: Params, xc, yc, mc):
    """Sums over one chunk: (masked CE, mask, masked correct argmax)."""
    logits = dense(head, xc).float()
    lse = torch.logsumexp(logits, -1)
    gold = torch.gather(logits, -1, yc[..., None])[..., 0]
    ncorrect = torch.sum((logits.argmax(-1) == yc) * mc)
    return torch.sum((lse - gold) * mc), torch.sum(mc), ncorrect


def _chunked_ce(head: Params, x, labels, mask, chunk: int = 512):
    """x: [B,T,D] final hidden; labels/mask: [B,T]. Returns (mean CE,
    accuracy) over the mask; each chunk of ``min(chunk, T)`` positions
    is checkpointed."""
    t = x.shape[1]
    chunk = min(chunk, t)
    if t % chunk:
        raise ValueError(f"sequence length {t} is not a multiple of the "
                         f"CE chunk {chunk}")
    tot = cnt = ncorr = torch.zeros((), device=x.device)
    for c0 in range(0, t, chunk):
        sl = slice(c0, c0 + chunk)
        ce, n, nc = checkpoint(_ce_chunk, head, x[:, sl], labels[:, sl],
                               mask[:, sl], use_reentrant=False,
                               preserve_rng_state=False)
        tot, cnt, ncorr = tot + ce, cnt + n, ncorr + nc
    cnt = torch.clamp(cnt, min=1.0)
    return tot / cnt, ncorr / cnt


def loss_fn(cfg: ModelConfig, params: Params, batch: Batch, *,
            remat: bool = True):
    """Next-token LM loss (decoders), or the loss on ``batch["labels"]``
    (with ``batch["mask"]``, default all ones; per-frame classification
    for encoders). Returns (loss, {"ce", "acc", "moe_aux"}), 0-d tensors
    on the params' device."""
    x, extras = forward(cfg, params, batch, remat=remat)
    dev = x.device
    if cfg.is_encoder or "labels" in batch:
        labels = torch.as_tensor(batch["labels"], device=dev).long()
        mask = (torch.as_tensor(batch["mask"], device=dev).float()
                if "mask" in batch else
                torch.ones(labels.shape, device=dev))
    else:
        # next-token: shift left, zero-mask the final position so the
        # time axis stays chunk-divisible
        toks = torch.as_tensor(batch["tokens"], device=dev).long()
        labels = torch.cat([toks[:, 1:], torch.zeros_like(toks[:, :1])], 1)
        mask = torch.ones(toks.shape, device=dev)
        mask[:, -1] = 0.0
    loss, acc = _chunked_ce(params["head"], x, labels, mask)
    total = loss + cfg.router_aux_loss_coef * extras["moe_aux"]
    return total, {"ce": loss, "acc": acc, "moe_aux": extras["moe_aux"]}


# --------------------------------------------------------------------------
# prefill / decode (serving path)
# --------------------------------------------------------------------------

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
    for lp in unstack(params["blocks"]):
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
    for lp, kl, vl in zip(unstack(params["blocks"]), kc.unbind(0),
                          vc.unbind(0)):
        h = rms_norm(x, lp["norm1"], cfg.norm_eps)
        a, _, _ = attn_decode(cfg, lp["attn"], h, kl, vl, pos, positions,
                              kv_len)
        x = x + a
        h = rms_norm(x, lp["norm2"], cfg.norm_eps)
        x = x + swiglu(lp["mlp"], h)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return _head_logits(params, x[:, 0]), cache
