"""Long-context decode example on PyTorch: RWKV6 (attention-free, O(1)
state) greedy generation with per-token likelihoods feeding the paper's
sequence supervisor (min-likelihood reducer, §5.3.4) — the generative
analogue of the classification cascade used for the long_500k serving
shape. The counterpart of ``examples/generate_long_context.py``; on a
GPU the time mix runs through the RWKV6 scan kernel and each token is
picked by the maxconf kernel.

    PYTHONPATH=src python -m repro_torch.examples.generate_long_context [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.supervisors import (seq_min_likelihood,
                                          seq_prod_likelihood)
from repro_torch.device import resolve_device
from repro_torch.models import transformer as T
from repro_torch.serving.generate import greedy_generate
from repro_torch.tree import tree_leaves

T_REMOTE = 0.05


def generate(cfg, params, prompt: np.ndarray, max_new_tokens: int) -> dict:
    """Greedy tokens and their likelihoods for ``prompt`` [B, T] on the
    params' device, with both sequence reducers and the acceptance at
    ``T_REMOTE`` (numpy)."""
    dev = params["final_norm"].device
    toks, liks = greedy_generate(
        cfg, params, {"tokens": torch.as_tensor(prompt, device=dev)},
        max_new_tokens)
    return {"tokens": toks.cpu().numpy(), "liks": liks.cpu().numpy(),
            "conf_min": seq_min_likelihood(liks).cpu().numpy(),
            "conf_prod": seq_prod_likelihood(liks).cpu().numpy()}


def cache_bytes(cfg, max_len: int, device) -> int:
    return sum(x.numel() * x.element_size()
               for x in tree_leaves(T.make_cache(cfg, 1, max_len,
                                                 device=device)))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--new-tokens", type=int, default=12)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_config("rwkv6-1.6b").reduced()
    params = T.init_params(cfg, torch.Generator(dev).manual_seed(args.seed))
    rng = np.random.default_rng(args.seed)
    prompt = rng.integers(1, cfg.vocab_size, (2, 48)).astype(np.int32)

    out = generate(cfg, params, prompt, args.new_tokens)
    print(f"[gen] generated tokens:\n{out['tokens']}")
    print(f"[gen] per-token likelihoods (row 0): "
          f"{np.round(out['liks'][0], 3)}")

    # 2nd-level supervision on the generated answer (paper's QA reducer)
    print(f"[gen] min-reducer confidence : {np.round(out['conf_min'], 4)}")
    print(f"[gen] prod-reducer confidence: {np.round(out['conf_prod'], 4)} "
          f"(length-biased — the paper argues for min)")
    accepted = out["conf_min"] > T_REMOTE
    print(f"[gen] accepted at t={T_REMOTE}: {accepted.tolist()} "
          f"(rejected answers would trigger the fallback)")

    # O(1) state: the RWKV cache is the same size whatever the context
    b64, b500k = cache_bytes(cfg, 64, dev), cache_bytes(cfg, 524_288, dev)
    print(f"[gen] cache bytes @64 ctx: {b64:,} == @524k ctx: {b500k:,} -> "
          f"long_500k decode is O(1) memory (why this arch runs that shape)")

    assert out["tokens"].shape == out["liks"].shape == (2, args.new_tokens)
    assert ((out["tokens"] >= 0) & (out["tokens"] < cfg.vocab_size)).all()
    assert np.isfinite(out["liks"]).all() and (out["liks"] <= 1.0).all()
    assert (out["conf_prod"] <= out["conf_min"] + 1e-6).all()
    assert b64 == b500k, "the RWKV6 state grew with the context"
    return {**out, "accepted": accepted, "cache_bytes": (b64, b500k)}


if __name__ == "__main__":
    main()
