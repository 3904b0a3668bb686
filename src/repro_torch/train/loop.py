"""Training step builder + host loop (port of ``repro.train.loop``).

``make_train_step(cfg, opt_cfg)`` returns ``train_step(params, opt_state,
batch) -> (params, opt_state, metrics)``: ``loss_fn`` and its gradient
with respect to every parameter leaf, then one AdamW step. The step
updates ``params`` and ``opt_state`` in place and returns them (the
counterpart of the buffer donation JAX's launcher jits the step with),
so a full-width model never holds two copies of its weights or moments.
"""

from __future__ import annotations

import time
from typing import Callable

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.transformer import loss_fn
from repro_torch.train.optimizer import (AdamWConfig, adamw_step_,
                                         init_opt_state)
from repro_torch.tree import tree_map, unstack


def value_and_grad(cfg: ModelConfig, params, batch, *, remat: bool = True):
    """(loss, metrics, grads): ``loss_fn`` and its gradient for every leaf
    of ``params``, in a tree of the same structure.

    Autograd follows detached aliases of the leaves (``params`` is not
    marked), the stacked ``[L, ...]`` blocks and dense blocks as one
    alias per layer. The moment a leaf's gradient is complete, a hook
    copies it into its slice of ``grads`` (allocated up front) and drops
    it: the backward holds ``grads`` and the gradients of about one
    layer, never the per-layer pieces of every leaf beside their stack.
    A leaf that gets no gradient raises."""
    grads = tree_map(torch.empty_like, params)
    made, done = [], []

    def follow(p, g):
        leaf = p.detach().requires_grad_()
        made.append(1)

        def sink(t):
            g.copy_(t.grad)
            t.grad = None
            done.append(1)

        leaf.register_post_accumulate_grad_hook(sink)
        return leaf

    tree = {k: ([tree_map(follow, lp, lg) for lp, lg in
                 zip(unstack(v), unstack(grads[k]))]
                if k in ("dense_blocks", "blocks")
                else tree_map(follow, v, grads[k]))
            for k, v in params.items()}
    loss, metrics = loss_fn(cfg, tree, batch, remat=remat)
    loss.backward()
    if len(done) != len(made):
        raise RuntimeError(f"{len(made) - len(done)} of the {len(made)} "
                           f"parameter tensors (a layer's slice of a "
                           f"stacked leaf counts once) got no gradient")
    metrics = {k: v.detach() for k, v in metrics.items()}
    return loss.detach(), metrics, grads


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig,
                    remat: bool = True) -> Callable:
    def train_step(params, opt_state, batch):
        loss, metrics, grads = value_and_grad(cfg, params, batch,
                                              remat=remat)
        stats = adamw_step_(opt_cfg, params, grads, opt_state)
        metrics = dict(metrics, loss=loss, **stats)
        return params, opt_state, metrics

    return train_step


def train_loop(cfg: ModelConfig, params, batches, opt_cfg: AdamWConfig,
               steps: int, log_every: int = 10,
               callback: Callable[[int, dict], None] | None = None):
    """Single-host training loop (examples / smoke tests). Trains
    ``params`` in place and returns (params, opt_state, history), one
    record of float metrics (plus ``step`` and ``elapsed_s``) at the
    first step and every ``log_every``-th. JAX's ``jit`` flag has no
    counterpart: the step runs eagerly."""
    step_fn = make_train_step(cfg, opt_cfg)
    opt_state = init_opt_state(params)
    it = iter(batches)
    history = []
    t0 = time.perf_counter()
    for i in range(steps):
        params, opt_state, metrics = step_fn(params, opt_state, next(it))
        if (i + 1) % log_every == 0 or i == 0:
            m = {k: float(v) for k, v in metrics.items()}
            m["step"] = i + 1
            m["elapsed_s"] = time.perf_counter() - t0
            history.append(m)
            if callback:
                callback(i + 1, m)
    return params, opt_state, history
