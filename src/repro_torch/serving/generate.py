"""Greedy generation over the port's model API (prefill + decode loop).

Returns per-token likelihoods of the chosen tokens so the sequence
supervisors (``core.supervisors.seq_min_likelihood`` — the paper's QA
reducer) apply directly: the generative analogue of the classification
cascade. On CUDA tensors the prefill runs the flash-attention kernel,
every decode step the decode-attention kernel once per layer (for RWKV6,
the prefill and every step the RWKV6 scan kernel once per layer), and
each token is picked by the maxconf kernel (argmax and max-softmax in one
pass over the vocabulary); the loop never synchronises with the host.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.maxconf.ops import maxconf
from repro_torch.models.transformer import decode_step, make_cache, prefill


def _pick(logits: torch.Tensor):
    out = maxconf(logits)
    return out["prediction"], out["max_softmax"]


def graft(cache: dict, pcache: dict) -> dict:
    """Copy a prefill's cache, covering positions [0, t), into a serving
    cache from ``make_cache``, along the slot axis of every leaf: the
    ``"main"`` and ``"dense"`` stacks' keys and values, or MLA's latent
    ``c_kv`` and ``k_rope`` (under SWA with t > window the prefill
    returns the whole ring, already rolled, and is taken as it is). An
    RWKV6 state has the same shape in both and is taken as it is."""
    if "rwkv" in pcache:
        cache["rwkv"] = pcache["rwkv"]
        return cache
    for group, leaves in pcache.items():
        for name, src in leaves.items():
            dst = cache[group][name]
            if dst.shape == src.shape:
                cache[group][name] = src
            else:
                dst[:, :, :src.shape[2]] = src
    return cache


@torch.no_grad()
def greedy_generate(cfg: ModelConfig, params, prompt_batch: dict,
                    max_new_tokens: int):
    """prompt_batch: {"tokens": [B, T]}. Runs on the params' device with a
    cache of T + max_new_tokens slots (or the window, under SWA).
    Returns (tokens [B, max_new_tokens] int32, likelihood
    [B, max_new_tokens] f32), both on that device."""
    if "tokens" not in prompt_batch:
        raise NotImplementedError("generation from embeddings comes with "
                                  "the frontend families")
    b, t = prompt_batch["tokens"].shape
    dev = params["embed"].device

    logits, pcache = prefill(cfg, params, prompt_batch)
    cache = graft(make_cache(cfg, b, t + max_new_tokens, device=dev), pcache)

    tok, lik = _pick(logits)
    toks, liks = [tok], [lik]
    for i in range(max_new_tokens - 1):
        logits, cache = decode_step(cfg, params, tok, cache, t + i)
        tok, lik = _pick(logits)
        toks.append(tok)
        liks.append(lik)
    return torch.stack(toks, 1), torch.stack(liks, 1)
