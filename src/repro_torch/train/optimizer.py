"""AdamW with global-norm clipping and warmup + cosine schedule, in
PyTorch (same update as ``repro.train.optimizer``).

``adamw_step_`` updates parameters and moments in place, the counterpart
of the buffer donation JAX's train step jits with: it goes a chunk of
rows at a time (a layer slice of a stacked ``[L, ...]`` leaf), so no fp32
copy of a whole leaf is ever made. ``adamw_update`` is the functional
form, like the JAX version: it returns new parameter and state trees and
leaves its inputs as they are (it runs ``adamw_step_`` on copies, so the
two agree bit for bit). Moments are fp32; the step count is a Python int,
so the schedule is host arithmetic.
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


CHUNK = 1 << 25     # elements a step works on at once (128 MiB in fp32)


def _chunks(t: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """Views of ``t`` in runs of whole rows along dim 0, each of at most
    ``CHUNK`` elements or one row: a layer slice at a time for yi-6b's
    stacked weights."""
    if t.dim() == 0:
        return (t,)
    return t.split(max(1, CHUNK // max(1, math.prod(t.shape[1:]))))


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in fp32, a chunk at a
    time."""
    return torch.sqrt(sum(torch.sum(torch.square(c.float()))
                          for x in tree_leaves(tree) for c in _chunks(x)))


@torch.no_grad()
def adamw_step_(cfg: AdamWConfig, params: Any, grads: Any,
                state: dict) -> dict:
    """One AdamW step in place: ``params`` and ``state`` (``m``, ``v``
    and ``step``) are updated, ``grads`` only read. Returns the stats
    {"grad_norm" (0-d tensor), "lr"}."""
    step = state["step"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    lr = lr_schedule(cfg, step)
    b1c = 1 - cfg.b1 ** step
    b2c = 1 - cfg.b2 ** step
    for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                          tree_leaves(state["m"]), tree_leaves(state["v"])):
        decay = p.dim() >= 2      # decay matrices only (norms/bias exempt)
        for pc, gc, mc, vc in zip(_chunks(p), _chunks(g), _chunks(m),
                                  _chunks(v)):
            gc = gc.float() * scale
            mc.mul_(cfg.b1).add_(gc, alpha=1 - cfg.b1)
            vc.mul_(cfg.b2).addcmul_(gc, gc, value=1 - cfg.b2)
            delta = torch.div(mc, b1c).div_(
                torch.div(vc, b2c).sqrt_().add_(cfg.eps))
            p32 = pc.float()      # pc itself when the leaf is fp32
            if decay:
                delta.add_(p32, alpha=cfg.weight_decay)
            pc.copy_(p32.sub_(delta, alpha=lr))
    state["step"] = step
    return {"grad_norm": gnorm, "lr": lr}


def adamw_update(cfg: AdamWConfig, params: Any, grads: Any,
                 state: dict) -> tuple[Any, dict, dict]:
    """Returns (new_params, new_state, stats); the inputs are not
    modified."""
    with torch.no_grad():
        new_p = tree_map(torch.clone, params)
        new_state = {"m": tree_map(torch.clone, state["m"]),
                     "v": tree_map(torch.clone, state["v"]),
                     "step": state["step"]}
    stats = adamw_step_(cfg, new_p, grads, new_state)
    return new_p, new_state, stats
