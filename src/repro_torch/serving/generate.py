"""Greedy generation over the port's model API (prefill + decode loop).

Returns per-token likelihoods of the chosen tokens so the sequence
supervisors (``core.supervisors.seq_min_likelihood`` — the paper's QA
reducer) apply directly: the generative analogue of the classification
cascade. On CUDA tensors the prefill runs the flash-attention kernel,
every decode step the decode-attention kernel once per layer (zamba: once
per group, its mamba2 layers in plain PyTorch; for RWKV6, the prefill and
every step the RWKV6 scan kernel once per layer), and
each token is picked by the maxconf kernel (argmax and max-softmax in one
pass over the vocabulary); the loop never synchronises with the host.
Under a recording profiler the prefill (with its token's pick), the
cache's graft and each decode step (with its pick) are the spans
``generate.prefill``, ``generate.graft`` and ``generate.step``
(``runtime.observability.span``).
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.maxconf.ops import maxconf
from repro_torch.models.transformer import decode_step, make_cache, prefill
from repro_torch.runtime.observability import span


def _pick(logits: torch.Tensor):
    out = maxconf(logits)
    return out["prediction"], out["max_softmax"]


def graft(cache: dict, pcache: dict) -> dict:
    """Copy a prefill's cache, covering positions [0, t), into a serving
    cache from ``make_cache``, along the slot axis (dim 2) of every leaf
    whose shape differs: the ``"main"`` and ``"dense"`` stacks' keys and
    values, MLA's latent ``c_kv`` and ``k_rope``, or zamba's per-group
    ``"attn_k"`` and ``"attn_v"`` (tensors at the top level). A group or
    leaf of the same shape in both is taken as it is: a recurrent state
    (RWKV6's, zamba's mamba2 state), and under SWA with t > window the
    prefill's whole ring, already rolled."""
    def put(dst: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
        if dst.shape == src.shape:
            return src
        dst[:, :, :src.shape[2]] = src
        return dst

    for key, src in pcache.items():
        dst = cache[key]
        if not isinstance(src, dict):
            cache[key] = put(dst, src)
        elif all(dst[n].shape == leaf.shape for n, leaf in src.items()):
            cache[key] = src
        else:
            for name, leaf in src.items():
                dst[name] = put(dst[name], leaf)
    return cache


@torch.no_grad()
def greedy_generate(cfg: ModelConfig, params, prompt_batch: dict,
                    max_new_tokens: int):
    """prompt_batch: {"tokens": [B, T]}, {"embeds": [B, T, D]}, or both
    (a VLM: the embeddings first). Runs on the params' device with a
    cache of T + max_new_tokens slots (or the window, under SWA), T the
    whole prompt's length: decoding starts at position T. (JAX's
    ``greedy_generate`` takes T from the tokens alone when a prompt has
    both, so its decoding overwrites the patch prefix's slots; the port
    does not follow it there.) Returns (tokens [B, max_new_tokens]
    int32, likelihood [B, max_new_tokens] f32), both on that device."""
    with span("generate.prefill"):
        logits, pcache = prefill(cfg, params, prompt_batch)
        tok, lik = _pick(logits)
    parts = [prompt_batch[k].shape[:2] for k in ("embeds", "tokens")
             if k in prompt_batch]
    b, t = parts[0][0], sum(n for _, n in parts)
    dev = params["final_norm"].device
    with span("generate.graft"):
        cache = graft(make_cache(cfg, b, t + max_new_tokens, device=dev),
                      pcache)

    toks, liks = [tok], [lik]
    for i in range(max_new_tokens - 1):
        with span("generate.step"):
            logits, cache = decode_step(cfg, params, tok, cache, t + i)
            tok, lik = _pick(logits)
        toks.append(tok)
        liks.append(lik)
    return torch.stack(toks, 1), torch.stack(liks, 1)
