"""The remote tier's model API, in PyTorch — every family of
``repro.models.transformer``: the attention family (GQA or MLA attention,
a dense or MoE MLP), RWKV6, the zamba hybrid (mamba2 layers with a shared
attention block) and the frontend archs (embedding inputs).

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
and ``params["dense_blocks"]`` may also be given as that list of
per-layer trees: the train step does so, to collect each layer's
gradient on its own.

An attention block holds GQA attention (``layers``) or MLA (``use_mla``,
``models.mla``) and a swiglu MLP or an MoE layer (``num_experts``,
``models.moe``). A config with ``first_dense_layers`` runs that many
dense-MLP blocks, ``params["dense_blocks"]``, before the others, and its
serving cache keeps them under ``"dense"`` beside ``"main"``. MLA caches
its latent ``{"c_kv", "k_rope"}`` in place of ``{"k", "v"}``.

A batch holds ``"tokens"`` [B, T], ``"embeds"`` [B, T, D] (a frontend's
output, ``models.frontend``), or both (a VLM: the patch embeddings come
first, then the text tokens' embeddings). Only token-taking archs and
pixtral have an ``embed`` table; hubert (an encoder) has none and takes
embeddings only. ``decode_step`` takes a [B] token or a [B, D]
embedding.

``forward`` and ``loss_fn`` are the train path: functional, differentiable
and free of kernels — attention through the plain ``gqa_attention``, MLA
and MoE in plain PyTorch (JAX runs them in jnp) and the RWKV6 and mamba2
recurrences through their plain loops, as JAX computes them, with
``remat`` checkpointing each layer (``torch.utils.checkpoint``, where JAX
uses ``jax.checkpoint``; for zamba each mamba layer, as JAX does).
``forward`` returns the MoE layers' load-balance losses, summed, as
``moe_aux``, which ``loss_fn`` adds with ``router_aux_loss_coef``.
Cross-entropy goes in sequence chunks, each checkpointed, so the [B, T,
V] logits live for one chunk at a time (on a mesh, each chip's rows and
its shard of the vocabulary: ``shard_hints.logsumexp``, ``take`` and
``argmax`` reduce the shards). ``loss_fn`` is the next-token
loss, over the text region only for a VLM batch, or the loss on
``batch["labels"]`` (per-frame classification for encoders).

``prefill`` and ``decode_step`` are the serving path, through the Hopper
kernels on a CUDA tensor (call them under ``torch.no_grad()``: the kernels
have no backward); MLA, MoE and mamba2 launch none, and MoE runs dropless
there. ``decode_step`` writes the new token's keys and values (MLA: its
latent and rope key; RWKV6 and mamba2: the recurrent state) into the
cache in place (JAX returns a new cache; the port returns the same one).
``prefill`` is causal for every arch, the encoder too, as JAX's is
(``forward`` is bidirectional for an encoder).

RWKV6 (``block_type == "rwkv6"``) keeps the recurrent state
``{"rwkv": {"wkv" [L,B,H,M,M], "tm_prev", "cm_prev" [L,B,D]}}`` (fp32) of
``repro.models.rwkv6.rwkv6_state`` as its cache. ``prefill`` runs the
stack from a zeroed state and returns it; ``decode_step`` runs the same
stack on one token (the token shift then concatenates the stored previous
token with an empty ``x[:, :-1]``, as JAX does) and updates the state in
place, layer by layer; ``forward`` runs it from a zero state without
keeping one.

The zamba hybrid (``block_type == "mamba2"``) runs ``num_layers /
shared_attn_period`` groups; each runs the shared attention block
(``params["shared_attn"]``, one unstacked attention + swiglu block) first,
then its ``shared_attn_period`` mamba2 layers (``params["blocks"]``:
``norm`` and ``mixer``). Its cache is ``{"mamba": {"ssm", "conv_x",
"conv_bc"}`` (fp32, ``models.mamba2.mamba2_state``), ``"attn_k"``,
``"attn_v"`` [G, B, slots, K, hd]}``: one KV cache per group.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import mamba2 as m2
from repro_torch.models import mla as mla_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import rwkv6 as rwkv
from repro_torch.models.layers import (Params, attention_params, attn_decode,
                                       attn_forward, attn_prefill, dense,
                                       decode_inputs, dense_params,
                                       make_kv_cache, normal, rms_norm,
                                       swiglu, swiglu_params)
from repro_torch.models.shard_hints import (argmax, cache_like, checkpoint,
                                           logsumexp, put_layer, rows,
                                           take)
from repro_torch.tree import unstack

Batch = dict[str, Any]

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "float16": torch.float16}

# the attention family's stacks in the order they run, each with its
# serving cache's key
STACKS = (("dense_blocks", "dense"), ("blocks", "main"))


def _is_rwkv(cfg: ModelConfig) -> bool:
    return cfg.block_type == "rwkv6"


def _is_zamba(cfg: ModelConfig) -> bool:
    return cfg.block_type == "mamba2"


def takes_tokens(cfg: ModelConfig) -> bool:
    """Whether the arch has a token embedding (``init_params``'s rule, as
    JAX's: every arch without a frontend, and pixtral)."""
    return not cfg.takes_embeddings or cfg.name.startswith("pixtral")


def zamba_groups(cfg: ModelConfig) -> tuple[int, int]:
    """(groups, mamba layers per group) of the zamba hybrid."""
    period = cfg.shared_attn_period
    if not period or cfg.num_layers % period:
        raise ValueError(f"{cfg.name}: {cfg.num_layers} layers do not "
                         f"divide into groups of {period}")
    return cfg.num_layers // period, period


def _blocks(gen: torch.Generator, cfg: ModelConfig, dtype, stack: tuple,
            moe: bool) -> Params:
    """Blocks stacked ``stack`` (``(n,)``; ``()`` for one unstacked
    block): the norms, then RWKV6's mixes, or attention (GQA or MLA) and a
    swiglu MLP or an MoE layer."""
    d, dev = cfg.d_model, gen.device
    blocks = {"norm1": torch.ones((*stack, d), dtype=dtype, device=dev),
              "norm2": torch.ones((*stack, d), dtype=dtype, device=dev)}
    if _is_rwkv(cfg):
        blocks.update(rwkv.rwkv6_params(gen, cfg, dtype, stack=stack))
        return blocks
    attn = mla_mod.mla_params if cfg.use_mla else attention_params
    blocks["attn"] = attn(gen, cfg, dtype, stack=stack)
    if moe:
        blocks["moe"] = moe_mod.moe_params(gen, cfg, dtype, stack=stack)
    else:
        blocks["mlp"] = swiglu_params(gen, d, cfg.d_ff, dtype, stack=stack)
    return blocks


def init_params(cfg: ModelConfig, gen: torch.Generator) -> Params:
    """Random parameters drawn directly on ``gen.device`` in the config's
    dtype (a full-width bf16 model never needs an fp32 copy; the MoE
    router and mamba2's per-head constants are fp32, as in JAX)."""
    dtype, dev = DTYPES[cfg.dtype], gen.device
    d = cfg.d_model
    out_dim = cfg.num_classes or cfg.vocab_size
    p = {}
    if takes_tokens(cfg):
        p["embed"] = normal(gen, (cfg.vocab_size, d), dtype, 0.02)
    p["final_norm"] = torch.ones(d, dtype=dtype, device=dev)
    p["head"] = dense_params(gen, d, out_dim, dtype)
    if _is_zamba(cfg):
        n = cfg.num_layers
        p["blocks"] = {"norm": torch.ones((n, d), dtype=dtype, device=dev),
                       "mixer": m2.mamba2_params(gen, cfg, dtype,
                                                 stack=(n,))}
        p["shared_attn"] = _blocks(gen, cfg, dtype, (), moe=False)
        return p
    n_dense = 0 if _is_rwkv(cfg) else cfg.first_dense_layers
    if n_dense:
        p["dense_blocks"] = _blocks(gen, cfg, dtype, (n_dense,), moe=False)
    p["blocks"] = _blocks(gen, cfg, dtype, (cfg.num_layers - n_dense,),
                          moe=cfg.is_moe)
    return p


def _num_layers(params: Params) -> int:
    return params["blocks"]["norm1"].shape[0]


def _device(params: Params) -> torch.device:
    return params["final_norm"].device


def _embed_in(cfg: ModelConfig, params: Params, batch: Batch) -> torch.Tensor:
    """The stack's input: the frontend embeddings, the tokens' embeddings,
    or (a VLM) the embeddings first, then the tokens', along T."""
    dev = _device(params)
    parts = []
    if "embeds" in batch:
        parts.append(torch.as_tensor(batch["embeds"], device=dev)
                     .to(DTYPES[cfg.dtype]))
    if "tokens" in batch and "embed" in params:
        tokens = torch.as_tensor(batch["tokens"], device=dev).long()
        # F.embedding: a DTensor table sharded over d_model gathers
        # locally (indexing would gather the whole table first)
        parts.append(F.embedding(tokens, params["embed"]))
    if not parts:
        raise ValueError(f"{cfg.name}: the batch needs 'tokens' and/or "
                         f"'embeds' (an arch without a token embedding "
                         f"takes 'embeds' only)")
    return parts[0] if len(parts) == 1 else torch.cat(parts, 1)


def _rwkv_body(cfg: ModelConfig, lp: Params, x, st: Params):
    """st: one layer's views {"wkv", "tm_prev", "cm_prev"} of the stacked
    state, updated in place; returns x."""
    h = rms_norm(x, lp["norm1"], cfg.norm_eps)
    out, _, tm_last = rwkv.time_mix(cfg, lp, h, st["wkv"], st["tm_prev"],
                                    s_out=st["wkv"])
    st["tm_prev"].copy_(tm_last)
    x = rows(x + out)
    h = rms_norm(x, lp["norm2"], cfg.norm_eps)
    out, cm_last = rwkv.channel_mix(cfg, lp, h, st["cm_prev"])
    st["cm_prev"].copy_(cm_last)
    return rows(x + out)


def _run_rwkv_stack(cfg: ModelConfig, params: Params, x, state: Params):
    """state: stacked [L, ...] rwkv6 state, updated in place layer by
    layer. Returns (x, state)."""
    for lp, st in zip(unstack(params["blocks"]), unstack(state)):
        x = _rwkv_body(cfg, lp, rows(x), st)
    return x, state


def _rwkv_train_body(cfg: ModelConfig, lp: Params, x):
    """One RWKV6 block from a zero state, functional and differentiable
    (JAX's ``_rwkv_body`` in ``forward``); the state it ends in is
    dropped."""
    x = rows(x)
    b, _, d = x.shape
    m = cfg.rwkv_head_dim
    # plain zeros (on a mesh: replicated; a DTensor's new_zeros would
    # copy its layout onto another shape)
    prev = torch.zeros((b, d), dtype=torch.float32, device=x.device)
    s0 = torch.zeros((b, d // m, m, m), dtype=torch.float32, device=x.device)
    h = rms_norm(x, lp["norm1"], cfg.norm_eps)
    out, _, _ = rwkv.time_mix(cfg, lp, h, s0, prev, differentiable=True)
    x = rows(x + out)
    h = rms_norm(x, lp["norm2"], cfg.norm_eps)
    out, _ = rwkv.channel_mix(cfg, lp, h, prev)
    return rows(x + out)


def _mlp(cfg: ModelConfig, lp: Params, h, *, dropless: bool = False):
    """The block's MLP on h: (y, the MoE load-balance loss, or None for a
    dense MLP)."""
    if "moe" in lp:
        return moe_mod.moe_forward(cfg, lp["moe"], h, dropless=dropless)
    return swiglu(lp["mlp"], h), None


def _attn_body(cfg: ModelConfig, lp: Params, x, positions, causal: bool):
    """One attention block, differentiable: (x, its MoE aux loss; 0 for a
    dense MLP)."""
    x = rows(x)
    h = rms_norm(x, lp["norm1"], cfg.norm_eps)
    if cfg.use_mla:
        a, _ = mla_mod.mla_forward(cfg, lp["attn"], h, positions,
                                   causal=causal)
    else:
        a = attn_forward(cfg, lp["attn"], h, positions, causal=causal)
    x = rows(x + a)
    h = rms_norm(x, lp["norm2"], cfg.norm_eps)
    y, aux = _mlp(cfg, lp, h)
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return rows(x + y), aux


def _mamba_body(cfg: ModelConfig, lp: Params, x, st: Params | None):
    """One mamba2 layer (norm, mixer, residual). ``st``: the layer's
    views of the stacked state, read and then overwritten in place with
    the state the layer ends in; None runs from a zero state without
    keeping one (differentiable: the train path)."""
    x = rows(x)
    h = rms_norm(x, lp["norm"], cfg.norm_eps)
    out, new = m2.mamba2_forward(cfg, lp["mixer"], h, state=st)
    if st is not None:
        for key, t in new.items():
            st[key].copy_(t)
    return rows(x + out)


def _run_zamba_stack(cfg: ModelConfig, params: Params, x, attn_fn,
                     state: Params | None = None, *, remat: bool = False):
    """The zamba groups in order: ``attn_fn(x, g)`` (group g's pass
    through the shared attention block: full sequence, prefill or
    decode), then the group's mamba2 layers. ``state``: the stacked
    [L, ...] mamba2 state, updated in place layer by layer (None: a zero
    state, not kept). ``remat`` checkpoints each mamba2 layer, as JAX
    does (not the shared block). Returns x."""
    g, per = zamba_groups(cfg)
    layers = unstack(params["blocks"])
    states = unstack(state) if state is not None else [None] * len(layers)
    for gi in range(g):
        x = attn_fn(x, gi)
        for li in range(gi * per, (gi + 1) * per):
            if remat:
                x = checkpoint(_mamba_body, cfg, layers[li], x, states[li])
            else:
                x = _mamba_body(cfg, layers[li], x, states[li])
    return x


def _shared_mlp(cfg: ModelConfig, sp: Params, x):
    """The second half of the shared attention block: norm, swiglu,
    residual."""
    x = rows(x)
    return rows(x + swiglu(sp["mlp"], rms_norm(x, sp["norm2"], cfg.norm_eps)))


def forward(cfg: ModelConfig, params: Params, batch: Batch, *,
            remat: bool = False):
    """Full-sequence hidden states [B,T,D] (+ aux dict: ``moe_aux``, the
    MoE layers' load-balance losses summed), differentiable; causal but
    for an encoder. ``remat`` recomputes each layer in the backward pass
    (a per-layer ``torch.utils.checkpoint``) instead of keeping its
    activations."""
    x = _embed_in(cfg, params, batch)
    aux = torch.zeros((), device=x.device)
    positions = torch.arange(x.shape[1], device=x.device)
    causal = not cfg.is_encoder
    if _is_zamba(cfg):
        sp = params["shared_attn"]
        x = _run_zamba_stack(
            cfg, params, x,
            lambda x, _: _attn_body(cfg, sp, x, positions, causal)[0],
            remat=remat)
        x = rms_norm(rows(x), params["final_norm"], cfg.norm_eps)
        return x, {"moe_aux": aux}
    if _is_rwkv(cfg):
        def body(lp, x):
            return _rwkv_train_body(cfg, lp, x), torch.zeros((),
                                                             device=x.device)
    else:
        def body(lp, x):
            return _attn_body(cfg, lp, x, positions, causal)
    for group, _ in STACKS:
        for lp in unstack(params[group]) if group in params else ():
            if remat:
                x, a = checkpoint(body, lp, x)
            else:
                x, a = body(lp, x)
            aux = aux + a
    x = rms_norm(rows(x), params["final_norm"], cfg.norm_eps)
    return x, {"moe_aux": aux}


# --------------------------------------------------------------------------
# loss (chunked cross-entropy: the [B,T,V] logits live one chunk at a time)
# --------------------------------------------------------------------------

def _ce_chunk(head: Params, xc, yc, mc):
    """Sums over one chunk: (masked CE, mask, masked correct argmax)."""
    logits = dense(head, xc).float()
    lse = logsumexp(logits)
    gold = take(logits, yc)
    ncorrect = torch.sum((argmax(logits) == yc) * mc)
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
                               mask[:, sl])
        tot, cnt, ncorr = tot + ce, cnt + n, ncorr + nc
    cnt = torch.clamp(cnt, min=1.0)
    return tot / cnt, ncorr / cnt


def _labels_and_mask(cfg: ModelConfig, batch: Batch, dev):
    """The loss's [B, T] labels and mask, in JAX's branch order: an
    encoder's ``labels`` (with ``mask``, default all ones); a decoder's
    given ``labels``; a VLM batch's next tokens over the text region only
    (the patch prefix and the last position masked); else the next
    tokens (the last position masked, so T stays chunk-divisible)."""
    if cfg.is_encoder or "labels" in batch:
        labels = torch.as_tensor(batch["labels"], device=dev).long()
        mask = (torch.as_tensor(batch["mask"], device=dev).float()
                if "mask" in batch else
                torch.ones(labels.shape, device=dev))
        return labels, mask
    toks = torch.as_tensor(batch["tokens"], device=dev).long()
    labels = torch.cat([toks[:, 1:], torch.zeros_like(toks[:, :1])], 1)
    mask = torch.ones(toks.shape, device=dev)
    mask[:, -1] = 0.0
    if "embeds" in batch:
        b, t_img = batch["embeds"].shape[:2]
        labels = torch.cat([torch.zeros((b, t_img), dtype=labels.dtype,
                                        device=dev), labels], 1)
        mask = torch.cat([torch.zeros((b, t_img), device=dev), mask], 1)
    return labels, mask


def loss_fn(cfg: ModelConfig, params: Params, batch: Batch, *,
            remat: bool = True):
    """Next-token LM loss (decoders; over the text region of a VLM batch),
    or the loss on ``batch["labels"]`` (with ``batch["mask"]``, default
    all ones; per-frame classification for encoders). Returns (loss,
    {"ce", "acc", "moe_aux"}), 0-d tensors on the params' device."""
    x, extras = forward(cfg, params, batch, remat=remat)
    labels, mask = _labels_and_mask(cfg, batch, x.device)
    loss, acc = _chunked_ce(params["head"], x, labels, mask)
    total = loss + cfg.router_aux_loss_coef * extras["moe_aux"]
    return total, {"ce": loss, "acc": acc, "moe_aux": extras["moe_aux"]}


# --------------------------------------------------------------------------
# prefill / decode (serving path)
# --------------------------------------------------------------------------

def _head_logits(params: Params, x_last):
    """x_last: [B, D] -> logits [B, V or C] fp32."""
    return dense(params["head"], x_last).float()


def _attn_entries(cfg: ModelConfig, lp: Params, x, positions):
    """A block's prefill attention on the stream x (its first norm,
    then GQA or MLA): (output, its cache entries {"k", "v"} or MLA's
    {"c_kv", "k_rope"}). The normed input is held only inside."""
    h = rms_norm(x, lp["norm1"], cfg.norm_eps)
    if cfg.use_mla:
        a, (c_kv, k_r) = mla_mod.mla_forward(cfg, lp["attn"], h, positions)
        return a, {"c_kv": c_kv, "k_rope": k_r}
    a, (k, v) = attn_prefill(cfg, lp["attn"], h, positions)
    return a, {"k": k, "v": v}


def _zamba_prefill(cfg: ModelConfig, params: Params, x, positions):
    """The zamba stack over the prompt from a zeroed state: (x, cache
    {"mamba", "attn_k", "attn_v" [G, B, T, K, hd]}), each group's keys
    and values written into the stacked cache as they are made."""
    sp = params["shared_attn"]
    g, _ = zamba_groups(cfg)
    kv = {"attn_k": None, "attn_v": None}

    def attn(x, gi):
        # rows: on a mesh, the residual stream whole on a row shard (a
        # mamba2 layer may leave it split over d_model), so the head
        # projections split their heads and not a partial sum of them
        x = rows(x)
        a, entries = _attn_entries(cfg, sp, x, positions)
        for key, t in (("attn_k", entries["k"]), ("attn_v", entries["v"])):
            kv[key] = put_layer(kv[key], gi, g, t)
        del entries
        x = x + a
        del a
        return _shared_mlp(cfg, sp, x)

    state = cache_like(
        lambda dev: m2.mamba2_state(cfg, x.shape[0], device=dev), x.device)
    x = _run_zamba_stack(cfg, params, x, attn, state)
    return x, {"mamba": state, **kv}


def prefill(cfg: ModelConfig, params: Params, batch: Batch):
    """Run the full prompt (causal, for an encoder too, as JAX's
    prefill); return (last-position logits [B, V] fp32, cache). The cache
    is {"main": {"k", "v": [L, B, T, K, hd]}} (MLA: {"c_kv" [L, B, T, r],
    "k_rope" [L, B, T, dr]}), with ``"dense"`` beside ``"main"`` for the
    first dense-MLP layers; for RWKV6 {"rwkv": state}; for zamba
    {"mamba": state, "attn_k", "attn_v" [G, B, T, K, hd]}. Each layer's
    entries go into the stacked cache as the layer makes them
    (``put_layer``). MoE runs dropless."""
    x = _embed_in(cfg, params, batch)
    positions = torch.arange(x.shape[1], device=x.device)
    if _is_rwkv(cfg):
        x, state = _run_rwkv_stack(cfg, params, x, cache_like(
            lambda dev: rwkv.rwkv6_state(cfg, x.shape[0], _num_layers(params),
                                         device=dev), x.device))
        x = rms_norm(rows(x), params["final_norm"], cfg.norm_eps)
        return _head_logits(params, x[:, -1]), {"rwkv": state}
    if _is_zamba(cfg):
        x, cache = _zamba_prefill(cfg, params, x, positions)
        x = rms_norm(rows(x), params["final_norm"], cfg.norm_eps)
        return _head_logits(params, x[:, -1]), cache
    cache = {}
    for group, name in STACKS:
        if group not in params:
            continue
        layers = unstack(params[group])
        kv: dict = {}
        for i, lp in enumerate(layers):
            x = rows(x)
            a, entries = _attn_entries(cfg, lp, x, positions)
            for key, t in entries.items():
                kv[key] = put_layer(kv.get(key), i, len(layers), t)
            del entries
            x = rows(x + a)
            del a
            x = rows(x + _mlp(cfg, lp, rms_norm(x, lp["norm2"], cfg.norm_eps),
                              dropless=True)[0])
        cache[name] = kv
    x = rms_norm(rows(x), params["final_norm"], cfg.norm_eps)
    return _head_logits(params, x[:, -1]), cache


def make_cache(cfg: ModelConfig, batch: int, max_len: int,
               device: str | torch.device = "cuda"):
    """Zeroed serving cache {"main": {"k", "v": [L, B, slots, K, hd]}} in
    the config's dtype (``slots = min(max_len, window)`` under SWA; MLA:
    {"c_kv", "k_rope"} of ``max_len`` slots), with ``"dense"`` beside
    ``"main"`` for the first dense-MLP layers; for RWKV6 the zeroed fp32
    recurrent state {"rwkv": ...}, whatever ``max_len``; for zamba the
    zeroed fp32 mamba2 state and a KV cache per group {"mamba": ...,
    "attn_k", "attn_v": [G, B, max_len, K, hd]}."""
    dev = resolve_device(device)
    dtype = DTYPES[cfg.dtype]
    if _is_rwkv(cfg):
        return {"rwkv": rwkv.rwkv6_state(cfg, batch, device=dev)}
    if _is_zamba(cfg):
        g, _ = zamba_groups(cfg)
        shape = (g, batch, max_len, cfg.num_kv_heads, cfg.resolved_head_dim)
        return {"mamba": m2.mamba2_state(cfg, batch, device=dev),
                "attn_k": torch.zeros(shape, dtype=dtype, device=dev),
                "attn_v": torch.zeros(shape, dtype=dtype, device=dev)}
    mk = mla_mod.make_mla_cache if cfg.use_mla else make_kv_cache
    n_dense = cfg.first_dense_layers
    cache = {"main": mk(cfg, batch, max_len, dtype,
                        layers=cfg.num_layers - n_dense, device=dev)}
    if n_dense:
        cache["dense"] = mk(cfg, batch, max_len, dtype, layers=n_dense,
                            device=dev)
    return cache


def _decode_input(cfg: ModelConfig, params: Params, token) -> torch.Tensor:
    """A step's [B, 1, D] input: the embedding of a [B] token, or a
    [B, D] embedding in the config's dtype."""
    token = torch.as_tensor(token, device=_device(params))
    if token.dim() == 1:
        return F.embedding(token.long(), params["embed"])[:, None, :]
    if token.dim() == 2:
        return token.to(DTYPES[cfg.dtype])[:, None, :]
    raise ValueError(f"decode_step takes a [B] token or a [B, D] "
                     f"embedding, not {tuple(token.shape)}")


def decode_step(cfg: ModelConfig, params: Params, token, cache, pos):
    """One new token. token: [B] int (on the params' device, or host
    ints), or a [B, D] embedding; pos: absolute position of the token, a
    host int or a 0-d integer tensor on the cache's device (for GQA
    caches, plain tensors: ``layers.decode_inputs``; read from memory,
    so ``serving.generate`` replays the step as a CUDA graph).
    Writes its keys and values (MLA: its latent and rope key; RWKV6 and
    mamba2: the new recurrent state) into ``cache`` in place; returns
    (logits [B, V] fp32, cache)."""
    if not cfg.supports_decode:
        raise ValueError(f"{cfg.name} is encoder-only")
    x = _decode_input(cfg, params, token)
    b = x.shape[0]
    if _is_rwkv(cfg):
        x, _ = _run_rwkv_stack(cfg, params, x, cache["rwkv"])
        x = rms_norm(rows(x), params["final_norm"], cfg.norm_eps)
        return _head_logits(params, x[:, 0]), cache
    if _is_zamba(cfg):
        sp = params["shared_attn"]
        positions, kv_len, slot = decode_inputs(
            cfg, pos, b, cache["attn_k"].shape[2], x.device)

        def attn(x, gi):
            x = rows(x)         # as in _zamba_prefill
            h = rms_norm(x, sp["norm1"], cfg.norm_eps)
            a, _, _ = attn_decode(cfg, sp["attn"], h, cache["attn_k"][gi],
                                  cache["attn_v"][gi], slot, positions,
                                  kv_len)
            return _shared_mlp(cfg, sp, x + a)

        x = _run_zamba_stack(cfg, params, x, attn, cache["mamba"])
        x = rms_norm(rows(x), params["final_norm"], cfg.norm_eps)
        return _head_logits(params, x[:, 0]), cache
    slots = next(iter(cache["main"].values())).shape[2]
    positions, kv_len, slot = decode_inputs(cfg, pos, b, slots, x.device)
    for group, name in STACKS:
        if name not in cache:
            continue
        for lp, lc in zip(unstack(params[group]), unstack(cache[name])):
            x = rows(x)
            h = rms_norm(x, lp["norm1"], cfg.norm_eps)
            if cfg.use_mla:
                a, _, _ = mla_mod.mla_decode(cfg, lp["attn"], h, lc["c_kv"],
                                             lc["k_rope"], pos, positions)
            else:
                a, _, _ = attn_decode(cfg, lp["attn"], h, lc["k"], lc["v"],
                                      slot, positions, kv_len)
            x = rows(x + a)
            h = rms_norm(x, lp["norm2"], cfg.norm_eps)
            x = rows(x + _mlp(cfg, lp, h, dropless=True)[0])
    x = rms_norm(rows(x), params["final_norm"], cfg.norm_eps)
    return _head_logits(params, x[:, 0]), cache
