"""AdamW with global-norm clipping and warmup + cosine schedule, in
PyTorch (same update as ``repro.train.optimizer``).

Functional, like the JAX version: ``adamw_update`` returns new parameter
and state trees (the inputs are not modified). Moments are fp32; the
step count is a Python int, so the schedule is host arithmetic.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

import torch

from repro_torch.tree import tree_leaves, tree_map


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def lr_schedule(cfg: AdamWConfig, step: int) -> float:
    """Linear warmup + cosine decay to min_lr_ratio."""
    if step < cfg.warmup_steps:
        return cfg.lr * step / max(cfg.warmup_steps, 1)
    prog = min(max((step - cfg.warmup_steps)
                   / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0), 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 \
        * (1 + math.cos(math.pi * prog))
    return cfg.lr * cos


def init_opt_state(params: Any) -> dict:
    zeros = lambda a: torch.zeros(a.shape, dtype=torch.float32,  # noqa: E731
                                  device=a.device)
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": 0}


def global_norm(tree: Any) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree_leaves(tree)))


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params: Any, grads: Any,
                 state: dict) -> tuple[Any, dict, dict]:
    """Returns (new_params, new_state, stats)."""
    step = state["step"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    lr = lr_schedule(cfg, step)
    b1c = 1 - cfg.b1 ** step
    b2c = 1 - cfg.b2 ** step

    def upd(p, g, m, v):
        g = g.float() * scale
        m = cfg.b1 * m + (1 - cfg.b1) * g
        v = cfg.b2 * v + (1 - cfg.b2) * g * g
        delta = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
        if p.dim() >= 2:  # decay matrices only (norms/bias exempt)
            delta = delta + cfg.weight_decay * p.float()
        return (p.float() - lr * delta).to(p.dtype), m, v

    out = tree_map(upd, params, grads, state["m"], state["v"])
    stats = {"grad_norm": gnorm, "lr": lr}
    return (_unzip(out, 0),
            {"m": _unzip(out, 1), "v": _unzip(out, 2), "step": step}, stats)


def _unzip(tree: Any, i: int) -> Any:
    """Element ``i`` of every ``(p, m, v)`` leaf of ``tree`` (parameter
    trees hold dicts and lists only, so a tuple here is a leaf)."""
    if isinstance(tree, dict):
        return {k: _unzip(v, i) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_unzip(v, i) for v in tree]
    return tree[i]
