"""End-to-end training example on PyTorch: train a ~100M-param local
surrogate family member (a reduced deepseek-v2-lite — MLA + MoE) for a
few hundred steps on the synthetic LM stream, with checkpointing.

This exercises the port's training substrate: config system, MoE/MLA
blocks, chunked CE, AdamW + cosine schedule in place, msgpack
checkpoints readable by the JAX package. The counterpart of
``examples/train_surrogate.py``.

    PYTHONPATH=src python -m repro_torch.examples.train_surrogate [--steps 300]
    PYTHONPATH=src python -m repro_torch.examples.train_surrogate \\
        --device cpu --scale smoke --steps 3
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.models import transformer as T
from repro_torch.train.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.train.loop import make_train_step
from repro_torch.train.optimizer import AdamWConfig, init_opt_state
from repro_torch.tree import tree_leaves


def build_cfg(scale: str):
    base = get_config("deepseek-v2-lite-16b")
    if scale == "smoke":         # CI-sized
        return base.reduced()
    # ~100M-param family member: same block structure, narrower dims
    return dataclasses.replace(
        base, name="deepseek-v2-mini-100m", num_layers=6, d_model=768,
        num_heads=8, head_dim=96, d_ff=2048, vocab_size=16384,
        kv_lora_rank=192, qk_nope_head_dim=64, qk_rope_head_dim=32,
        v_head_dim=64, num_experts=8, num_experts_per_tok=2,
        num_shared_experts=1, moe_d_ff=512, first_dense_layers=1,
        dtype="float32")


def data_stream(vocab: int, batch: int, seq: int, seed: int,
                device: torch.device):
    """Markov-chain token stream (learnable structure, not pure noise)."""
    rng = np.random.default_rng(seed)
    trans = rng.dirichlet(np.full(64, 0.05), size=vocab)  # sparse rows
    nxt_choices = np.argsort(-trans, axis=1)[:, :64].astype(np.int32)
    nxt_probs = np.take_along_axis(trans, nxt_choices, axis=1)
    nxt_probs /= nxt_probs.sum(1, keepdims=True)
    while True:
        out = np.empty((batch, seq), np.int32)
        out[:, 0] = rng.integers(0, vocab, batch)
        for t in range(1, seq):
            r = rng.random(batch)
            cum = np.cumsum(nxt_probs[out[:, t - 1]], axis=1)
            pick = (r[:, None] > cum).sum(1)
            out[:, t] = nxt_choices[out[:, t - 1], pick]
        yield {"tokens": torch.as_tensor(out, device=device)}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--scale", choices=("smoke", "100m"), default="100m")
    ap.add_argument("--checkpoint", default=os.path.join(
        tempfile.gettempdir(), "surrogate_ckpt.msgpack"))
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = build_cfg(args.scale)
    params = T.init_params(cfg, torch.Generator(dev).manual_seed(args.seed))
    n_params = sum(x.numel() for x in tree_leaves(params))
    print(f"[example] {cfg.name}: {n_params / 1e6:.1f}M params, "
          f"{args.steps} steps of batch {args.batch} x seq {args.seq}")

    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=20, total_steps=args.steps)
    step = make_train_step(cfg, opt_cfg, remat=False)
    opt = init_opt_state(params)
    stream = data_stream(cfg.vocab_size, args.batch, args.seq, args.seed,
                         dev)

    t0, losses = time.perf_counter(), []
    for i in range(args.steps):
        params, opt, m = step(params, opt, next(stream))
        losses.append(float(m["ce"]))
        if (i + 1) % 25 == 0 or i == 0:
            dt = time.perf_counter() - t0
            print(f"[example] step {i + 1:4d} ce={losses[-1]:.4f} "
                  f"acc={float(m['acc']):.3f} "
                  f"moe_aux={float(m['moe_aux']):.3f} "
                  f"({dt / (i + 1):.2f} s/step)")

    first, last = np.mean(losses[:10]), np.mean(losses[-10:])
    print(f"[example] CE {first:.3f} -> {last:.3f} "
          f"({(1 - last / first):.0%} reduction)")
    assert np.isfinite(losses).all(), "a non-finite loss"
    if args.steps >= 50:
        assert last < first, "training did not reduce loss"

    save_checkpoint(args.checkpoint, params, step=args.steps)
    restored, step_no = load_checkpoint(args.checkpoint, params)
    assert step_no == args.steps
    assert all(torch.equal(a, b.to(a.device)) for a, b in
               zip(tree_leaves(params), tree_leaves(restored)))
    print(f"[example] checkpoint round-trip OK -> {args.checkpoint}")
    return {"params": n_params, "ce_first": float(first),
            "ce_last": float(last), "steps": args.steps}


if __name__ == "__main__":
    main()
